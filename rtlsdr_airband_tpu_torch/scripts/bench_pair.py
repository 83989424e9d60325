"""K1's pair schedule on the card: parity, then K1 alone a block in both
schedules.

Counterpart of the JAX package's ``scripts/bench_pair.py``, its
latency-floor experiment: the JAX probe found that a second independent
dependency chain rides the first one's latency at about +1 % on the TPU.
Does the real kernel get the same overlap when each thread steps two
channels together (``demod_block_cuda(pair=True)``, ``csrc/demod_sched.cu``:
a block of two 32-channel tiles on 32 threads, one warp with two chains)
against the default (a 64-channel block, two warps with one chain each)?

Protocol: ``build_flagship(BENCH_PAIR_CHANNELS, sample_rate=2_560_000,
wave_rate=16000)`` (default 8192 channels), its block channelized; parity:
the pair schedule against the default on that block, audio, IQ, flags and
every state leaf bit for bit.  Then K = BENCH_PAIR_K (default 8) random
blocks (seed 1: |N(0, 1)| magnitudes, N(0, 0.5) IQ, the JAX script's
inputs), the state threaded by the default; K1 alone a block by CUDA events
(``scripts/bench_scaling.py::kernel_ms``, min of 3 reps), the mean over the
K blocks, in both schedules, at unroll BENCH_PAIR_UNROLL (default 1).

    python -m rtlsdr_airband_tpu_torch.scripts.bench_pair

Prints ONE JSON line: the JAX keys (``metric`` demod_pair_coschedule,
``channels``, ``ms_single``, ``ms_pair``, ``speedup``, ``parity``) plus the
schedule that ran (where the count of 32-channel tiles is odd pair runs the
default schedule, as in JAX) and the card's name and power limit.  Exits 1
when parity fails.  The card only: without a card it exits 1.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

from .bench_unroll import schedule_times
from .common import device_fields, require_card, same_outputs


def main() -> int:
    device = require_card("bench_pair", "K1's schedules run on the card only (the plain version has none)")
    if device is None:
        return 1
    from ..models.flagship import build_flagship
    from ..ops import demod_cuda
    from ..ops.channelizer import channelize_matmul

    C = int(os.environ.get("BENCH_PAIR_CHANNELS", "8192"))
    K = int(os.environ.get("BENCH_PAIR_K", "8"))
    unroll = int(os.environ.get("BENCH_PAIR_UNROLL", "1"))
    block, x, state = build_flagship(n_channels=C, sample_rate=2_560_000, wave_rate=16000, device=device)
    kw = block.block_kwargs
    mags, iqs = channelize_matmul(x, block.bins, block.window, hop=kw["hop"], fft_size=kw["fft_size"], n_frames=kw["n_frames"],
                                  taps=(block.taps_re, block.taps_im))

    # parity: the pair schedule against the default on the flagship block
    single, pair = (demod_cuda.resolve_schedule(C, unroll, p) for p in (False, True))
    a = demod_cuda.demod_block_cuda(block.params, state, mags, iqs, unroll=unroll, pair=False)
    b = demod_cuda.demod_block_cuda(block.params, state, mags, iqs, unroll=unroll, pair=True)
    torch.cuda.synchronize()
    parity = {
        "audio_maxdiff": (a[1] - b[1]).abs().max().item(),
        "flags_equal": bool(torch.equal(a[3], b[3])),
        "cur_diff": int((a[0].cur - b[0].cur).abs().max().item()),
        "bit_for_bit": same_outputs(a, b),
    }
    print(f"[pair] parity: {parity}", file=sys.stderr, flush=True)

    rng = np.random.default_rng(1)
    W = kw["n_frames"]
    blocks = [
        (torch.as_tensor(np.abs(rng.normal(0, 1.0, (W, C))).astype(np.float32), device=device),
         torch.as_tensor(rng.normal(0, 0.5, (W, C, 2)).astype(np.float32), device=device))
        for _ in range(K)
    ]
    res = schedule_times(block.params, state, blocks, [single, pair])
    ms_single, ms_pair = res[single][0], res[pair][0]
    timed_equal = all(res[pair][2])
    print(f"[pair] {demod_cuda.schedule_name(*single)}: {ms_single:.4f} ms/block, {demod_cuda.schedule_name(*pair)}: "
          f"{ms_pair:.4f} ms/block", file=sys.stderr, flush=True)
    print(json.dumps({
        "metric": "demod_pair_coschedule", "channels": C, "ms_single": ms_single, "ms_pair": ms_pair,
        "speedup": ms_single / ms_pair, "parity": dict(parity, timed_blocks_bit_for_bit=timed_equal),
        "schedule": demod_cuda.schedule_name(*pair), "unroll": unroll, "k_blocks": K,
        "ms_single_per_block": res[single][1], "ms_pair_per_block": res[pair][1], **device_fields(device),
    }), flush=True)
    return 0 if parity["bit_for_bit"] and timed_equal else 1


if __name__ == "__main__":
    sys.exit(main())
