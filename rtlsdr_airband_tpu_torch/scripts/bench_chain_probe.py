"""Latency probe K2 on the card: how long is a step of pure dependent float
arithmetic at the demod kernel's launch geometry, does a second independent
chain per thread ride in its latency shadow, and does doubling the thread
count cost anything?

Counterpart of ``scripts/bench_chain_probe.py`` (the JAX script), with the
same kinds, sizes, input and JSON keys.  Each kind is W loop trips of a chain
of L dependent links ``v = v * 0.9995 + x * 1e-4`` on every lane of row 0 of
a float32 [2, SUBL, 128] tile, the state carried between trips:

  chain1   one chain; row 1 comes out as ``x[1]``;
  chain2   two independent chains interleaved link by link, the second on
           row 1 as ``v * 0.9997 + x * 1e-4``;
  chain1w  chain1 at twice SUBL (twice the threads).

``chain_probe`` launches the CUDA kernel (``csrc/chain_probe.cu``) for CUDA
tensors and runs the plain version, ``chain_probe_plain``, for CPU tensors.
Timing follows the JAX script: K distinct blocks a dispatch, each block's
output summed into one scalar that is fetched, a warm-up, then the minimum
over REPS of the dispatch's time divided by K (CUDA events on the card).

    python -m rtlsdr_airband_tpu_torch.scripts.bench_chain_probe             # on the card
    PROBE_CPU=1 python -m rtlsdr_airband_tpu_torch.scripts.bench_chain_probe  # plain version, CPU

The last line of standard output is one JSON object with the JAX script's
keys plus ``device``; on the card an earlier line gives the card's name and
power limit.  A CPU run's times are those of the plain version on the host.
"""

from __future__ import annotations

import ctypes
import functools
import json
import os
import sys
import time

import numpy as np
import torch

from .. import _build
from .common import card_line

W = 2000  # loop trips (= audio samples per block)
L = 40  # dependent links per chain per trip
SUBL = 32
REPS = 5
K = 4  # blocks a dispatch

LAUNCHES = 0  # kernel launches by chain_probe; the plain version never counts

CHAINS = {"chain1": 1, "chain1w": 1, "chain2": 2}  # kind -> independent chains a thread
KERNEL_LINKS = (4, 40)  # the kernel's compiled chain lengths: the tests' and the script's L


def chain_probe_plain(x: torch.Tensor, kind: str, w_trips: int, links: int = L) -> torch.Tensor:
    """The probe in plain PyTorch: one operation at a time, each rounded to
    float32 once (no fused multiply-add), as the kernel built with
    --fmad=false rounds.  x: float32 [2, SUBL, 128]; returns the final state."""
    f32 = functools.partial(torch.tensor, dtype=torch.float32, device=x.device)
    ka, kb, eps = f32(0.9995), f32(0.9997), f32(1e-4)
    a, b = x[0], x[1]
    xa, xb = a * eps, b * eps
    two = CHAINS[kind] == 2
    for _ in range(w_trips * links):
        a = a * ka + xa
        if two:
            b = b * kb + xb
    return torch.stack([a, b])


def _check(x, kind: str, w_trips: int) -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"x: expected a tensor, got {type(x).__name__}")
    if x.dtype != torch.float32:
        raise ValueError(f"x: dtype {x.dtype}, expected torch.float32")
    if x.dim() != 3 or x.shape[0] != 2 or x.shape[1] < 1 or x.shape[2] != 128:
        raise ValueError(f"x: shape {tuple(x.shape)}, expected (2, SUBL, 128) with SUBL >= 1")
    if not x.is_contiguous():
        raise ValueError("x: not contiguous")
    if kind not in CHAINS:
        raise ValueError(f"kind {kind!r}: expected one of {sorted(CHAINS)}")
    if not 0 <= w_trips < 2**31:
        raise ValueError(f"w_trips {w_trips}: expected 0 <= w_trips < 2**31")


@functools.cache
def cuda_library() -> ctypes.CDLL:
    """The nvcc-built ``csrc/chain_probe.cu``, built at first use and kept,
    so a timed dispatch spends no host time on the build's source hash."""
    lib = _build.load_kernel("chain_probe.cu")
    lib.chain_probe_launch.restype = ctypes.c_int
    lib.chain_probe_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    return lib


def chain_probe(x: torch.Tensor, kind: str, w_trips: int, links: int = L) -> torch.Tensor:
    """The final state of ``kind`` after ``w_trips`` trips of ``links``
    links, a new float32 [2, SUBL, 128] tensor.  A CUDA tensor launches the
    kernel or raises; a CPU tensor takes the plain version."""
    global LAUNCHES
    _check(x, kind, w_trips)
    if x.device.type == "cpu":
        return chain_probe_plain(x, kind, w_trips, links)
    if x.device.type != "cuda":
        raise ValueError(f"chain_probe: unsupported device {x.device}")
    if links not in KERNEL_LINKS:
        raise ValueError(f"links {links}: the kernel is compiled for {KERNEL_LINKS}")
    lib = cuda_library()
    with torch.cuda.device(x.device):
        out = torch.empty_like(x)
        rc = lib.chain_probe_launch(
            x.data_ptr(), out.data_ptr(), CHAINS[kind], x.shape[1] * x.shape[2], links, w_trips,
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"chain probe kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out


def probe_inputs(device) -> dict[str, torch.Tensor]:
    """The JAX script's inputs, drawn in its order: for each kind, K blocks
    float32 [K, 2, subl, 128] of normal noise from ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    return {
        kind: torch.as_tensor(rng.normal(size=(K, 2, subl, 128)).astype(np.float32), device=device)
        for kind, subl in (("chain1", SUBL), ("chain2", SUBL), ("chain1w", 2 * SUBL))
    }


def _dispatch(xs: torch.Tensor, kind: str) -> torch.Tensor:
    """One dispatch: the K blocks of ``xs`` through the probe, their final
    states summed into one scalar (the JAX script's scan)."""
    total = torch.zeros((), dtype=torch.float32, device=xs.device)
    for x in xs:
        total = total + chain_probe(x, kind, W, L).sum()
    return total


def _seconds_per_block(xs: torch.Tensor, kind: str) -> float:
    """Min over REPS of one dispatch's time / K, after a warm-up.  On the
    card: CUDA events around the K launches and sums, then the scalar is
    fetched; on the CPU: the host clock around the dispatch and the fetch."""
    _dispatch(xs, kind).item()
    best = float("inf")
    for _ in range(REPS):
        if xs.device.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            total = _dispatch(xs, kind)
            end.record()
            total.item()
            s = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            _dispatch(xs, kind).item()
            s = time.perf_counter() - t0
        best = min(best, s / K)
    return best


def probe(device) -> dict:
    """Time the three kinds on ``device``; the JAX script's JSON object plus
    ``device`` (the card's name, or "cpu")."""
    device = torch.device(device)
    out = {}
    for kind, xs in probe_inputs(device).items():
        s = _seconds_per_block(xs, kind)
        out[kind] = dict(ms_per_block=s * 1e3, us_per_step=s / W * 1e6, subl=xs.shape[2])
        print(f"[probe] {kind}: {out[kind]}", file=sys.stderr, flush=True)
    c1, c2, c1w = (out[k]["us_per_step"] for k in ("chain1", "chain2", "chain1w"))
    verdict = (
        "latency-bound: second chain rides the shadow -> co-scheduling viable"
        if c2 < 1.35 * c1
        else "issue/ordering-bound: chains serialize -> co-scheduling buys nothing"
    )
    return {"metric": "chain_probe", "W": W, "L": L, "kinds": out,
            "chain2_vs_chain1": c2 / c1, "wide_vs_chain1": c1w / c1, "verdict": verdict,
            "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"}


def main(device=None) -> int:
    """Run the probe on ``device``: the card unless PROBE_CPU=1 or the caller
    asks for the CPU.  Without a card it fails rather than run on the CPU."""
    if device is None:
        device = "cpu" if os.environ.get("PROBE_CPU", "0") == "1" else "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            print("bench_chain_probe: no CUDA device (PROBE_CPU=1 runs the plain version on the CPU)", file=sys.stderr)
            return 1
        print(card_line(), flush=True)
    print(json.dumps(probe(device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
