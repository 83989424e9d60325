"""K1's unroll schedule on the card: K1 alone a block at each unroll.

Counterpart of the JAX package's ``scripts/bench_unroll.py``, its
latency-floor experiment: a block is W = 2000 dependent steps a channel, so
at a few hundred channels it costs its per-step latency.  Does stepping U
samples a loop trip (``demod_block_cuda(unroll=U)``, ``csrc/demod_sched.cu``)
lower it?

Protocol: ``build_flagship(BENCH_CHANNELS, wave_rate=16000)`` (default 512
channels, as in JAX), K = 8 random blocks (seed 7, magnitudes and IQ
uniform in [0, 0.1), the JAX script's inputs) with the state threaded block
to block by the default schedule; for each U of BENCH_UNROLLS (default
1,2,4), K1 alone on each block by CUDA events
(``scripts/bench_scaling.py::kernel_ms``: one warm-up, min over 3 reps), the
mean over the K blocks.  Every U's outputs must equal the default's bit for
bit on every block, or the script exits 1.

    python -m rtlsdr_airband_tpu_torch.scripts.bench_unroll
    BENCH_CHANNELS=8192 BENCH_UNROLLS=1,4 python -m rtlsdr_airband_tpu_torch.scripts.bench_unroll

One JSON line a U: the JAX keys (``unroll``, ``demod_ms_per_block``,
``us_per_step``, ``n_channels``) plus the schedule, K1's time on each block,
the bit-for-bit verdict and the card's name and power limit.  The card only:
the plain version has no schedule, so the CPU has nothing to measure; without
a card the script exits 1.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

from .common import device_fields, require_card, same_outputs

K_BLOCKS, REPS = 8, 3


def schedule_times(params, state, blocks, schedules, reps: int = REPS) -> dict:
    """K1 alone on each block in each schedule (unroll, pair), resolved
    already, the state threaded by the default schedule.  Returns
    {schedule: (ms a block, list, [the outputs equal the default's on every
    block])}."""
    from .bench_scaling import kernel_ms

    ref, st = [], state
    for mags, iqs in blocks:
        _ms, out = kernel_ms(params, st, mags, iqs, reps=1)
        ref.append((st, out))
        st = out[0]
    res = {}
    for unroll, pair in schedules:
        times, same = [], []
        for (mags, iqs), (st_in, want) in zip(blocks, ref):
            ms, got = kernel_ms(params, st_in, mags, iqs, reps, unroll=unroll, pair=pair)
            times.append(ms)
            same.append(same_outputs(want, got))
        res[unroll, pair] = (sum(times) / len(times), times, same)
    return res


def main() -> int:
    device = require_card("bench_unroll", "K1's schedules run on the card only (the plain version has none)")
    if device is None:
        return 1
    from ..models.flagship import build_flagship
    from ..ops import demod_cuda

    C = int(os.environ.get("BENCH_CHANNELS", "512"))
    unrolls = tuple(int(u) for u in os.environ.get("BENCH_UNROLLS", "1,2,4").split(","))
    block, _x, state = build_flagship(n_channels=C, wave_rate=16000, device=device)
    W = block.block_kwargs["n_frames"]
    rng = np.random.default_rng(7)
    blocks = [
        (torch.as_tensor(rng.random((W, C), np.float32) * 0.1, device=device),
         torch.as_tensor(rng.random((W, C, 2), np.float32) * 0.1, device=device))
        for _ in range(K_BLOCKS)
    ]
    schedules = [demod_cuda.resolve_schedule(C, u, False) for u in unrolls]
    res = schedule_times(block.params, state, blocks, schedules)
    ok = True
    for (unroll, pair), (ms, times, same) in res.items():
        ok &= all(same)
        print(json.dumps({
            "unroll": unroll, "demod_ms_per_block": ms, "us_per_step": ms / W * 1e3, "n_channels": C,
            "schedule": demod_cuda.schedule_name(unroll, pair), "k1_ms_per_block": times,
            "equal_to_default_bit_for_bit": all(same), **device_fields(device),
        }), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
