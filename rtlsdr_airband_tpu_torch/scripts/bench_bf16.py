"""The channelizer's matrix products at each precision the card offers: time
a block and SNR against float64.

Counterpart of the JAX package's ``scripts/bench_bf16.py``: the four real
GEMMs of ``channelize_matmul`` (the windowed DFT at C bins, ``frames @
taps^T``) at C = BENCH_CHANNELS (default 8192), N = 512, hop = 160,
W = 2000, in each mode:

  ========  =============================================================
  mode      what runs on the card
  ========  =============================================================
  default   ``torch.matmul`` on float32 as the process's settings have it
            (PyTorch's default is full float32, TF32 off; the line gives
            ``allow_tf32`` and the float32 matmul precision it ran under)
  high      3xTF32: each operand split into a TF32 head (its low 13
            mantissa bits cleared) and the float32 remainder, and the three
            TF32 products head*head + (head*rest + rest*head) summed: the
            counterpart of JAX's multi-pass ``bf16_3x``
  highest   float32 with TF32 off: what ``channelize_matmul`` ships
  bf16      bfloat16 inputs, float32 accumulation and output
  tf32      one TF32 pass: the card's one-pass tensor-core mode, which
            stands where the TPU's one-pass ``default`` stood
  ========  =============================================================

Protocol: the JAX script's: an [L, 2] float32 input (seed 5, N(0, 0.1)),
random bins, the Blackman-Harris-7 window, taps by ``make_taps``.  SNR: the
mode's output on the first 64 frames against a float64 DFT at the bins of
the same frames.  Time: K = 8 distinct blocks (the input plus N(0, 0.01)
noise) through the four products and a checksum, CUDA events around the
chain, min over 3 reps, / K.  The gate: the end-to-end audio needs >= 80 dB
against the reference (``BENCH_SCALING.md``), so a mode's channelizer must
clear 80 dB.

    python -m rtlsdr_airband_tpu_torch.scripts.bench_bf16               # the card
    BENCH_DEVICE=cpu BENCH_CHANNELS=64 python -m rtlsdr_airband_tpu_torch.scripts.bench_bf16

One JSON line a mode: the JAX keys (``mode``, ``chan_ms``, ``snr_db``,
``n_channels``, ``gflops``: the function's 8 W N C flop over the time) plus
the gate, what ran and the card's name and power limit.  On the CPU
(``BENCH_DEVICE=cpu``, the host's times, no device metric) there is no TF32:
``tf32`` and ``high`` run float32 products, and ``bf16`` multiplies the
bfloat16-rounded inputs in float32; the line's ``runs`` says so.  The
driver changes nothing on the port's path: ``channelize_matmul`` stays
float32.  Without a card and without ``BENCH_DEVICE=cpu`` it exits 1.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time

import numpy as np
import torch

from .common import device_fields, pick_device

MODES = ("default", "high", "highest", "bf16", "tf32")
GATE_DB = 80.0
N, HOP, W = 512, 160, 2000
K_BLOCKS, REPS, SNR_FRAMES = 8, 3, 64
RUNS = {
    "cuda": {
        "default": "float32 torch.matmul under the process's settings",
        "high": "3xTF32: TF32 head and float32 remainder, three TF32 products summed",
        "highest": "float32, TF32 off",
        "bf16": "bfloat16 inputs, float32 accumulation and output",
        "tf32": "one TF32 pass",
    },
    "cpu": {
        "default": "float32 torch.matmul on the CPU",
        "high": "3 float32 products of the TF32 split (the CPU has no TF32)",
        "highest": "float32",
        "bf16": "bfloat16-rounded inputs multiplied in float32",
        "tf32": "float32 (the CPU has no TF32)",
    },
}


@contextlib.contextmanager
def _tf32(on: bool):
    """TF32 for CUDA float32 matmuls on or off within the block, restored
    after."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _tf32_split(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """t = head + rest, head with the 13 mantissa bits TF32 drops cleared
    (exact in TF32), rest the float32 remainder (exact)."""
    head = (t.contiguous().view(torch.int32) & -8192).view(torch.float32)
    return head, t - head


def product(mode: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in ``mode``, float32 out."""
    if mode == "default":
        return torch.matmul(a, b)
    if mode == "highest":
        with _tf32(False):
            return torch.matmul(a, b)
    if mode == "tf32":
        with _tf32(True):
            return torch.matmul(a, b)
    if mode == "high":
        (ah, ar), (bh, br) = _tf32_split(a), _tf32_split(b)
        with _tf32(True):
            return torch.matmul(ah, bh) + (torch.matmul(ah, br) + torch.matmul(ar, bh))
    if mode == "bf16":
        a16, b16 = a.bfloat16(), b.bfloat16()
        if a.device.type == "cuda":
            return torch.mm(a16, b16, out_dtype=torch.float32)
        return torch.matmul(a16.float(), b16.float())
    raise ValueError(f"unknown mode {mode!r}")


def channelize(mode: str, x: torch.Tensor, tr: torch.Tensor, ti: torch.Tensor):
    """(yr, yi) [W, C]: ``channelize_matmul``'s four products in ``mode``."""
    from ..ops.channelizer import make_frames

    frames = make_frames(x, HOP, N, W)
    fr, fi = frames[..., 0].contiguous(), frames[..., 1].contiguous()
    yr = product(mode, fr, tr.T) - product(mode, fi, ti.T)
    yi = product(mode, fr, ti.T) + product(mode, fi, tr.T)
    return yr, yi


def reference(x: np.ndarray, bins: np.ndarray, window: np.ndarray) -> np.ndarray:
    """[SNR_FRAMES, C] complex128: the windowed DFT at the bins of the first
    frames, in float64."""
    starts = np.arange(SNR_FRAMES) * HOP
    frames = np.stack([x[s : s + N] for s in starts]).astype(np.float64)
    z = frames[..., 0] + 1j * frames[..., 1]
    taps = window.astype(np.float64)[None, :] * np.exp(-2j * np.pi * (bins[:, None] * np.arange(N)[None, :]) / N)
    return z @ taps.T


def chain_ms(fn, xs, device) -> float:
    """min over REPS of the K-block chain's time (CUDA events on the card,
    the host clock on the CPU) / K, after one warm-up."""
    cuda = device.type == "cuda"

    def once() -> float:
        if cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        sums = [fn(xb) for xb in xs]
        torch.stack(sums).cpu()
        if not cuda:
            return (time.perf_counter() - t0) * 1e3
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    once()
    return min(once() for _ in range(REPS)) / len(xs)


def main() -> int:
    device = pick_device(os.environ.get("BENCH_DEVICE") == "cpu", "bench_bf16", "BENCH_DEVICE=cpu")
    if device is None:
        return 1
    from ..ops.channelizer import make_taps
    from ..ops.window import blackman_harris_7

    C = int(os.environ.get("BENCH_CHANNELS", "8192"))
    rng = np.random.default_rng(5)
    L = (W - 1) * HOP + N
    x_np = rng.normal(0, 0.1, (L, 2)).astype(np.float32)
    bins_np = rng.integers(0, N, C).astype(np.int32)
    window_np = np.asarray(blackman_harris_7(N), np.float32)
    ref = reference(x_np, bins_np, window_np)
    ref_pow = float(np.mean(np.abs(ref) ** 2))

    x = torch.as_tensor(x_np, device=device)
    tr, ti = make_taps(torch.as_tensor(bins_np, device=device), torch.as_tensor(window_np, device=device))
    noise = rng.normal(0, 0.01, (K_BLOCKS,) + x_np.shape).astype(np.float32)
    xs = [x + torch.as_tensor(noise[k], device=device) for k in range(K_BLOCKS)]
    settings = dict(allow_tf32=torch.backends.cuda.matmul.allow_tf32, float32_matmul_precision=torch.get_float32_matmul_precision())
    for mode in MODES:
        yr, yi = channelize(mode, x, tr, ti)
        got = yr[:SNR_FRAMES].double().cpu().numpy() + 1j * yi[:SNR_FRAMES].double().cpu().numpy()
        err = float(np.mean(np.abs(got - ref) ** 2))
        snr_db = 10 * np.log10(ref_pow / err) if err > 0 else float("inf")

        def checksum(xb, mode=mode):
            yr, yi = channelize(mode, xb, tr, ti)
            return yr.abs().sum() + yi.abs().sum()

        dt_ms = chain_ms(checksum, xs, device)
        line = {
            "mode": mode, "chan_ms": dt_ms, "snr_db": snr_db, "n_channels": C, "gflops": 8 * W * N * C / (dt_ms / 1e3) / 1e9,
            "gate_db": GATE_DB, "passes_gate": bool(snr_db >= GATE_DB), "runs": RUNS[device.type][mode],
            "snr_frames": SNR_FRAMES, **device_fields(device),
        }
        if mode == "default":
            line["settings"] = settings
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
