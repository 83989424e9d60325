"""Benchmark: demodulated channel throughput of the flagship block program
on one GPU.

Counterpart of the JAX package's ``bench.py`` (its lines 29-116): the same
population, protocol and JSON keys.  Metric: channel-Msps per GPU, channels
x input samples a second at the measured block rate.  Baseline anchor: the
reference's designed real-time workload, 8 channels x 2.56 Msps on a
Raspberry-Pi-class CPU (SURVEY.md section 6, reference constants
rtl_airband.h:64-94) = 20.48 channel-Msps; ``vs_baseline`` is the measured
throughput over it.

Protocol: ``build_flagship(BENCH_CHANNELS, wave_rate=16000)`` (its taps made
once, as ``Pipeline`` makes them once a retune); K = BENCH_BLOCKS distinct
input blocks (the flagship block plus seed-7 noise of sigma 0.01) through
the ``FlagshipBlock`` with the state threaded block to block; each block's
checksum ``sum(|audio|)`` stays on the device, the K checksums are fetched
to the host and the device synchronised; one warm-up, then the minimum over
BENCH_REPS of wall / K.  On the card the demod is the kernel K1; there is
no retry on another backend.

    python -m rtlsdr_airband_tpu_torch.scripts.bench                # the card
    BENCH_DEVICE=cpu BENCH_CHANNELS=64 BENCH_BLOCKS=2 BENCH_REPS=1 \\
        python -m rtlsdr_airband_tpu_torch.scripts.bench            # plain versions, CPU

BENCH_BACKEND=plain times the plain PyTorch demod instead of K1.  Prints ONE
JSON line: the JAX script's ``metric``, ``value``, ``unit``, ``vs_baseline``
and ``detail``, plus ``device`` and ``power_limit`` (nvidia-smi).  A CPU
run's numbers are the host's, not a device metric.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

from .common import device_fields, pick_device

SAMPLE_RATE = 2_560_000
WAVE_RATE = 16000


def flagship_blocks(n_channels: int, K: int, device):
    """(block, xs, state): the flagship block program, its K distinct input
    blocks and its initial state, as the JAX bench makes them."""
    from ..models.flagship import build_flagship

    block, x, state = build_flagship(n_channels=n_channels, sample_rate=SAMPLE_RATE, wave_rate=WAVE_RATE, device=device)
    rng = np.random.default_rng(7)
    noise = rng.normal(0, 0.01, (K,) + tuple(x.shape)).astype(np.float32)
    xs = [x + torch.as_tensor(noise[k], device=device) for k in range(K)]
    return block, xs, state


def chain_seconds(block, xs, state, reps: int) -> float:
    """The bench protocol: one warm-up, then the minimum over ``reps`` of
    the wall of the K-block chain (checksums fetched, device synchronised)
    over K."""
    cuda = xs[0].device.type == "cuda"

    def once() -> float:
        t0 = time.perf_counter()
        st, sums = state, []
        for xb in xs:
            st, out = block(xb, st)
            sums.append(out["audio"].abs().sum())
        torch.stack(sums).cpu().numpy()
        if cuda:
            torch.cuda.synchronize()
        return time.perf_counter() - t0

    once()
    return min(once() for _ in range(reps)) / len(xs)


def run(n_channels: int, K: int, reps: int, device, backend: str = "cuda") -> dict:
    device = torch.device(device)
    block, xs, state = flagship_blocks(n_channels, K, device)
    block.block_kwargs["demod_backend"] = backend
    dt = chain_seconds(block, xs, state, reps)
    W, hop = block.block_kwargs["n_frames"], block.block_kwargs["hop"]
    block_realtime = W / WAVE_RATE
    channel_msps = n_channels * (W * hop / dt) / 1e6
    on_card = device.type == "cuda"
    fields = device_fields(device)
    return {
        "metric": "demod_channel_throughput",
        "value": channel_msps,
        "unit": f"channel-Msps/{'GPU' if on_card else 'CPU'}",
        "vs_baseline": channel_msps / (8 * SAMPLE_RATE / 1e6),
        "detail": {
            "n_channels": n_channels,
            "block_ms": dt * 1e3,
            "realtime_factor": block_realtime / dt,
            "realtime_channel_capacity": int(n_channels * block_realtime / dt),
            "demod_backend": "cuda" if on_card and backend == "cuda" else "plain",
            "blocks_per_dispatch": K,
            "backend": device.type,
            "device": fields["device"],
        },
        **fields,
    }


def main() -> int:
    device = pick_device(os.environ.get("BENCH_DEVICE", "cuda") == "cpu", "bench", "BENCH_DEVICE=cpu")
    if device is None:
        return 1
    backend = os.environ.get("BENCH_BACKEND", "cuda")
    if backend not in ("cuda", "plain"):
        print(f"bench: BENCH_BACKEND must be cuda or plain, not {backend!r}", file=sys.stderr)
        return 1
    result = run(
        int(os.environ.get("BENCH_CHANNELS", "8192")),
        int(os.environ.get("BENCH_BLOCKS", "16")),
        int(os.environ.get("BENCH_REPS", "3")),
        device,
        backend,
    )
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
