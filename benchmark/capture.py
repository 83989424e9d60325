"""Taps the benchmark puts on the streaming path, from its own files.

``BlockTap`` wraps ``runtime/pipeline.py::pipeline_block``, which the chain
calls once a block in stream order, and keeps, for the blocks it is asked
to, what each started from and produced: references to the device tensors
(of the outputs, those a case reads), no copy and no extra work on the
device.  ``case`` turns one of them into a case of ``check.py`` once the
window has closed.
"""

from __future__ import annotations

import numpy as np

from .check import EXACT_SNAPS, FLOAT_SNAPS

OUTPUTS = ("audio", "open_flags") + FLOAT_SNAPS + EXACT_SNAPS  # what a case reads of a block's outputs


class BlockTap:
    """Keeps the blocks in ``keep``, and the newest ``recent`` blocks that end
    a chunk of ``chunk`` blocks: a window that closes at a chunk's end finds
    its last block there while the dispatch runs at most ``recent - 1``
    chunks ahead of the handler (the App's runs one ahead)."""

    def __init__(self, keep: set[int], chunk: int = 0, recent: int = 3):
        from rtlsdr_airband_tpu_torch.runtime import pipeline

        self._mod = pipeline
        self._orig = pipeline.pipeline_block
        self.keep = set(keep)
        self.calls = 0
        self.kept: dict[int, tuple] = {}

        def tapped(x, bins, window, params, state, **kw):
            st, out = self._orig(x, bins, window, params, state, **kw)
            b = self.calls
            if b in self.keep or (chunk and (b + 1) % chunk == 0):
                self.kept[b] = (state, {k: out[k] for k in OUTPUTS}, st)
                ends = sorted(k for k in self.kept if k not in self.keep)
                for k in ends[:-recent]:
                    del self.kept[k]
            self.calls += 1
            return st, out

        pipeline.pipeline_block = tapped

    def close(self) -> None:
        self._mod.pipeline_block = self._orig


def case(tap: BlockTap, b: int, users: np.ndarray, dev_idx: np.ndarray, scene, delivered: dict) -> dict:
    """Block ``b`` as a case: the program's outputs for ``users``, the state
    after it, the state it started from (or, for block 0, the priming bytes
    for the reference's own start) and what the sinks received."""
    import torch

    from .check import take_channels

    st_in, out, st = tap.kept[b]
    u = torch.as_tensor(users, device=out["audio"].device)
    c = dict(users=users, raw=scene.block_bytes(b), audio=out["audio"][:, u].cpu().numpy(),
             open_flags=out["open_flags"][:, u].cpu().numpy(),
             snap={k: out[k][u].cpu().numpy() for k in FLOAT_SNAPS + EXACT_SNAPS},
             state_out=take_channels(st, dev_idx), delivered=delivered)
    if b == 0:
        c["prime"] = scene.prime_bytes()
    else:
        c["state_in"] = take_channels(st_in, dev_idx)
    return c
