"""Scaling sweeps of the flagship block program, one JSON line a point.

Counterpart of the JAX package's ``scripts/bench_scaling.py``:

  --channels   channel-count sweep on one device, with bench.py's protocol
               (K = 8 distinct blocks, the state threaded, checksums
               fetched, min over 3 reps of wall / K); on the card each point
               also gives the demod's own time a block by CUDA events: K1
               alone (``k1_ms``, events right around its launch) and the
               wrapper ``demod_block_cuda`` (``demod_ms``: K1 plus the fade
               and tail assembly), each the mean over the K blocks of the
               min over 3 reps;
  --devices    device-count sweep of the sharded step (W = 256, C = 64)
               over meshes of GPUs, or of CPU cells with ``--device cpu``
               (the mesh's mechanics; CPU times are the host's).

    python -m rtlsdr_airband_tpu_torch.scripts.bench_scaling --channels 512 2048 8192 16384
    python -m rtlsdr_airband_tpu_torch.scripts.bench_scaling --device cpu --devices 1 2 4

``--channels`` also takes a comma-separated list.  Without a card and
without ``--device cpu`` it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from .bench import chain_seconds, flagship_blocks
from .common import device_fields, pick_device


def kernel_ms(params, state, mags, iqs, reps: int, with_ctcss: bool = True, unroll: int = 1, pair: bool = False):
    """K1 alone in schedule (unroll, pair), resolved already, with the CTCSS
    pass after it when ``with_ctcss``: CUDA events right around
    ``demod_cuda.launch_k1``, so the wrapper's checks, allocations and fade
    assembly fall outside.  Min over ``reps`` after one
    warm-up, and the last run's outputs.  Not counted in
    ``demod_cuda.LAUNCHES``."""
    from ..ops import demod_cuda

    times = []

    def launch(args):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        demod_cuda.launch_k1(args, unroll, pair)
        end.record()
        times.append((start, end))

    lib = demod_cuda.cuda_library()  # any K1 library: they take the same DemodArgs
    for _ in range(reps + 1):
        out = demod_cuda.run_with(launch, lib, params, state, mags, iqs, fm_quadri=False, with_ctcss=with_ctcss, with_iq=False)
    torch.cuda.synchronize()
    return min(s.elapsed_time(e) for s, e in times[1:]), out


def wrapper_ms(params, state, mags, iqs, reps: int) -> float:
    """``demod_block_cuda`` between CUDA events: min over ``reps`` after one
    warm-up."""
    from ..ops.demod_cuda import demod_block_cuda

    demod_block_cuda(params, state, mags, iqs, with_iq=False)
    best = float("inf")
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        demod_block_cuda(params, state, mags, iqs, with_iq=False)
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def demod_times(block, xs, state, reps: int = 3) -> dict:
    """K1 alone and its wrapper on each of the K blocks at the state that
    enters it, means over the blocks."""
    from ..ops.channelizer import channelize_matmul

    kw = block.block_kwargs
    params, taps = block.params, (block.taps_re, block.taps_im)
    k1, wrap, st = [], [], state
    for xb in xs:
        mags, iqs = channelize_matmul(xb, block.bins, block.window, hop=kw["hop"], fft_size=kw["fft_size"],
                                      n_frames=kw["n_frames"], taps=taps)
        ms, _ = kernel_ms(params, st, mags, iqs, reps)
        k1.append(ms)
        wrap.append(wrapper_ms(params, st, mags, iqs, reps))
        st, _ = block(xb, st)
    return {"k1_ms": sum(k1) / len(k1), "demod_ms": sum(wrap) / len(wrap), "k1_ms_per_block": k1}


def channel_sweep(counts, device, K: int = 8, reps: int = 3) -> list[dict]:
    device = torch.device(device)
    points = []
    for C in counts:
        block, xs, state = flagship_blocks(C, K, device)
        dt = chain_seconds(block, xs, state, reps)
        kw = block.block_kwargs
        point = {
            "sweep": "channels", "n_channels": C, "block_ms": dt * 1e3,
            "channel_msps": C * kw["n_frames"] * kw["hop"] / dt / 1e6, "realtime_factor": 0.125 / dt,
            "backend": "cuda" if device.type == "cuda" else "plain",
        }
        if device.type == "cuda":
            point.update(demod_times(block, xs, state, reps))
        point.update(device_fields(device))
        print(json.dumps(point), flush=True)
        points.append(point)
    return points


def device_sweep(counts, device) -> list[dict]:
    from ..models.flagship import build_flagship
    from ..parallel.sharding import make_pipeline_mesh, make_sharded_pipeline_step, replicate, shard_last

    device = torch.device(device)
    if device.type == "cuda" and torch.cuda.device_count() < max(counts):
        raise ValueError(f"--devices {max(counts)} needs as many GPUs, this machine has {torch.cuda.device_count()}")
    W, C = 256, 64
    block, x, state = build_flagship(n_channels=C, wave_batch=W, device=device)
    kw = block.block_kwargs
    points = []
    for n in counts:
        cells = ["cpu"] * n if device.type == "cpu" else [torch.device("cuda", i) for i in range(n)]
        mesh = make_pipeline_mesh(cells)
        step = make_sharded_pipeline_step(mesh, hop=kw["hop"], fft_size=kw["fft_size"], n_frames=W, with_ctcss=True)
        bins, window = replicate(mesh, block.bins), replicate(mesh, block.window)
        params, st = shard_last(mesh, block.params), shard_last(mesh, state)
        _st, audio, _iq, _act = step(x, bins, window, params, st)
        s0 = audio.abs().sum().item()
        t0 = time.perf_counter()
        for _ in range(3):
            _st, audio, _iq, _act = step(x, bins, window, params, st)
            audio.abs().sum().item()
        if device.type == "cuda":
            for d in set(mesh.cells):
                torch.cuda.synchronize(d)
        dt = (time.perf_counter() - t0) / 3
        point = {"sweep": "devices", "n_devices": n, "mesh": dict(mesh.shape), "block_ms": dt * 1e3,
                 "audio_checksum": s0, **device_fields(device)}
        print(json.dumps(point), flush=True)
        points.append(point)
    return points


def _counts(values) -> list[int]:
    return [int(v) for s in values for v in s.split(",") if v]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--channels", nargs="*", default=None)
    ap.add_argument("--devices", nargs="*", default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda", help="cpu: the plain versions, CPU cells")
    args = ap.parse_args(argv)
    device = pick_device(args.device == "cpu", "bench_scaling", "--device cpu")
    if device is None:
        return 1
    if args.devices is not None:
        device_sweep(_counts(args.devices) or [1, 2, 4, 8], device)
    else:
        channel_sweep(_counts(args.channels or []) or [512, 2048, 4096, 8192], device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
