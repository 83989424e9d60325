"""Faults planted in the timed path, which the comparison has to catch.

``planted(kind)`` swaps ``runtime/pipeline.py``'s demod for one that runs the
real one and then breaks what it returns, on any device:

- ``state_unchanged``: the block returns the state it was given;
- ``half_left_out``: the second half of the channels is left out (silent,
  closed, its state not carried forward);
- ``answer_altered``: the audio of every open sample is scaled by 0.99.
"""

from __future__ import annotations

import contextlib

KINDS = ("state_unchanged", "half_left_out", "answer_altered")


def _broken(kind: str, demod):
    import torch

    def broken(params, state, mags, iqs, **kw):
        st, audio, iq, flags = demod(params, state, mags, iqs, **kw)
        if kind == "state_unchanged":
            return state, audio, iq, flags
        if kind == "half_left_out":
            C = audio.shape[1]
            keep = torch.arange(C, device=audio.device) < C // 2

            def pick(a, b):
                if isinstance(a, tuple):
                    return type(a)(*(pick(x, y) for x, y in zip(a, b)))
                return torch.where(keep[None, :, None], a, b) if a.dim() == 3 else torch.where(keep, a, b)

            return pick(st, state), torch.where(keep, audio, 0.0), iq, flags & keep
        if kind == "answer_altered":
            return st, torch.where(flags, audio * 0.99, audio), iq, flags
        raise ValueError(f"unknown fault {kind!r}")

    return broken


@contextlib.contextmanager
def planted(kind: str):
    """The fault ``kind`` in the timed path while the block runs."""
    from rtlsdr_airband_tpu_torch.runtime import pipeline

    orig = pipeline.demod_block_cuda
    pipeline.demod_block_cuda = _broken(kind, orig)
    try:
        yield
    finally:
        pipeline.demod_block_cuda = orig
