"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (sm_90a, H100).

    python3 chip_smoke.py

Runs from the repository root and needs one CUDA device; it exits non-zero
without one, and without the port's package beside it.  It imports nothing
of JAX and nothing of the JAX package.  Phases, each fatal on failure:

1. device: the card's name and power limit (nvidia-smi);
2. build: nvcc builds every kernel from csrc/ (one process per source);
3. parity: on the 8192-channel active scene (build_flagship_stream, W = 2000,
   4 blocks: squelch opens and closes on the carriers, CTCSS banks decide)
   the demod kernel K1 against its plain PyTorch version on the same inputs;
4. channelizer: torch.matmul in float32 against float64, SNR >= 80 dB at
   C = 8192, N = 512, W = 2000;
5. main path: build_flagship(8192) on the card, K = 8 distinct blocks
   through the FlagshipBlock with the launch counters at 0, then timings
   with CUDA events on the same blocks and states (warm-up, min over reps):
   the block, the channelizer GEMMs, K1 alone on each block, the plain
   demod on the last block; K1's bound; a torch.profiler view of the K
   blocks by kernel;
6. the kernels line, the JSON kernels line, the card line and the result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

W_FLAGSHIP = 2000
C_FLAGSHIP = 8192
K_BLOCKS = 8
ATOL = 1e-4  # audio / IQ / float state; flags and int/bool state exact
BANK_ACCUMULATORS = ("fast.q1", "fast.q2", "slow.q1", "slow.q2")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
FP32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores
# float operations of one demod step for one channel outside the Goertzel
# banks (counted from csrc/demod_step.cuh: squelch ~25, derotation ~12,
# lowpass ~14, magnitude 4, post-filter MAs ~8, AM or NFM ~20, notch 9,
# ampfactor and clamp 3)
DEMOD_STEP_FLOPS = 95


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return r.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Min over ``reps`` of one call's device time, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    best = float("inf")
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def state_diffs(a_state, b_state) -> dict:
    """Per-leaf max difference (float) or mismatch count (int/bool)."""
    from rtlsdr_airband_tpu_torch.interop import state_to_numpy

    a, b = state_to_numpy(a_state), state_to_numpy(b_state)
    out = {}
    for k in a:
        if a[k].dtype.kind in "iub":
            out[k] = int(np.sum(a[k] != b[k]))
        else:
            d = np.abs(a[k].astype(np.float64) - b[k])
            if k in BANK_ACCUMULATORS:  # relative to the bank's scale, see tests/test_torch_demod.py
                d = d / np.maximum(1.0, np.abs(b[k].astype(np.float64)).max(axis=0))
            out[k] = float(d.max())
    return out


def check_state(diffs: dict, label: str) -> None:
    bad = {k: v for k, v in diffs.items() if (v != 0 if isinstance(v, int) else v > ATOL)}
    if bad:
        raise AssertionError(f"{label}: state outside the bars: {bad}")


def phase_parity(device) -> dict:
    """K1 against the plain version on the 8192-channel active scene."""
    import torch

    from rtlsdr_airband_tpu_torch.models.flagship import build_flagship_stream
    from rtlsdr_airband_tpu_torch.ops import demod_cuda
    from rtlsdr_airband_tpu_torch.ops.channelizer import channelize_matmul
    from rtlsdr_airband_tpu_torch.ops.demod import demod_block

    block, state, x_blocks, hot = build_flagship_stream(n_channels=C_FLAGSHIP, wave_batch=W_FLAGSHIP, n_blocks=4, device=device)
    kw = block.block_kwargs
    params = block.params
    ks = ps = state
    err = {"audio": 0.0, "iq": 0.0, "flags_mismatch": 0, "bitwise": True}
    for k, x in enumerate(x_blocks):
        mags, iqs = channelize_matmul(x, block.bins, block.window, hop=kw["hop"], fft_size=kw["fft_size"], n_frames=kw["n_frames"], taps=(block.taps_re, block.taps_im))
        t0 = time.perf_counter()
        kout = demod_cuda.demod_block_cuda(params, ks, mags, iqs, with_iq=True)
        pout = demod_block(params, ps, mags, iqs)
        if device.type == "cuda":
            torch.cuda.synchronize()
        err["audio"] = max(err["audio"], (kout[1] - pout[1]).abs().max().item())
        err["iq"] = max(err["iq"], (kout[2] - pout[2]).abs().max().item())
        err["flags_mismatch"] += int((kout[3] != pout[3]).sum().item())
        diffs = state_diffs(kout[0], pout[0])
        worst = max((v for v in diffs.values() if isinstance(v, float)), default=0.0)
        err["bitwise"] &= all(torch.equal(a, b) for a, b in zip(kout[1:], pout[1:])) and not any(diffs.values())
        log(f"parity block {k}: audio {err['audio']:.3e} iq {err['iq']:.3e} flag mismatches {err['flags_mismatch']} "
            f"int/bool leaves differing {sum(1 for v in diffs.values() if isinstance(v, int) and v)} "
            f"worst float state {worst:.3e}; bit for bit so far: {err['bitwise']} ({time.perf_counter() - t0:.1f} s)")
        if err["audio"] >= ATOL or err["iq"] >= ATOL or err["flags_mismatch"]:
            raise AssertionError(f"parity block {k}: outputs outside the bars: {err}")
        check_state(diffs, f"parity block {k}")
        ks, ps = kout[0], pout[0]
    opens = ps.open_count[hot].tolist()
    ct = [h for h in hot if bool(params.ctcss_enabled[h])]
    decided = [int(b.found[h] + b.not_found[h]) for h in ct for b in (ps.fast, ps.slow)]
    log(f"parity scene: hot channels {hot} open_count {opens}; CTCSS channel {ct} fast/slow decisions {decided}")
    if min(opens) <= 0 or len(ct) != 1 or sum(decided) <= 0:
        raise AssertionError("parity scene did not open every hot squelch or decide a CTCSS window")
    return err


def phase_snr(device) -> float:
    """The channelizer's float32 GEMMs against float64 at the flagship shape."""
    import torch

    from rtlsdr_airband_tpu_torch.models.flagship import build_flagship
    from rtlsdr_airband_tpu_torch.ops.channelizer import channelize_matmul, make_frames, make_taps

    block, x, _ = build_flagship(n_channels=C_FLAGSHIP, wave_rate=16000, device=device)
    kw = block.block_kwargs
    _, iq = channelize_matmul(x, block.bins, block.window, hop=kw["hop"], fft_size=kw["fft_size"], n_frames=kw["n_frames"])
    frames = make_frames(x, kw["hop"], kw["fft_size"], kw["n_frames"]).double()
    tr, ti = (t.double() for t in make_taps(block.bins, block.window))
    fr, fi = frames[..., 0], frames[..., 1]
    ref_r = fr @ tr.T - fi @ ti.T
    ref_i = fr @ ti.T + fi @ tr.T
    err = (iq[..., 0].double() - ref_r) ** 2 + (iq[..., 1].double() - ref_i) ** 2
    snr = 10.0 * torch.log10((ref_r**2 + ref_i**2).sum() / err.sum()).item()
    log(f"channelizer SNR vs float64: {snr:.2f} dB (C={C_FLAGSHIP}, N={kw['fft_size']}, W={kw['n_frames']})")
    if not snr >= 80.0:
        raise AssertionError(f"channelizer SNR {snr:.2f} dB < 80 dB")
    return snr


def demod_bound(params, state, mags) -> tuple[float, str, str]:
    """(bound_ms, bound_by, reckoning) of K1 on one block.

    Bytes: every input read once (mags, the W IQ pairs it consumes, params,
    state) and every output written once (state, audio, one flag byte).
    Operations: DEMOD_STEP_FLOPS per channel-sample, plus the two Goertzel
    banks (3 per tone and sample each) on every sample of every CTCSS
    channel - the most the banks could need, so the operations' time is an
    upper bound, and it stays below the bytes' time at the flagship shape."""
    from rtlsdr_airband_tpu_torch.ops.demod_cuda import _flat_state

    W, C = mags.shape
    state_bytes = sum(t.numel() * t.element_size() for t in _flat_state(state).values())
    param_bytes = sum(t.numel() * t.element_size() for t in params)
    nbytes = W * C * 4 + W * C * 2 * 4 + param_bytes + 2 * state_bytes + W * C * 4 + W * C * 1
    n_ctcss = int(params.ctcss_enabled.sum().item())
    tones = params.fast_mask.shape[0]
    flops = DEMOD_STEP_FLOPS * W * C + 2 * 3 * tones * W * n_ctcss
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / FP32_FLOPS * 1e3
    by = "bytes" if bytes_ms >= ops_ms else "operations"
    how = (f"{nbytes} B / 3.35 TB/s = {bytes_ms:.4f} ms; at most {flops} flop / 67 TFLOP/s = {ops_ms:.4f} ms")
    return max(bytes_ms, ops_ms), by, how


def kernel_ms(params, state, mags, iqs, reps: int, with_ctcss: bool = True) -> float:
    """K1 alone: CUDA events right around its launch, so the wrapper's
    checks, allocations and fade assembly fall outside.  Min over ``reps``
    after one warm-up.  Not counted in LAUNCHES."""
    import torch

    from rtlsdr_airband_tpu_torch.ops import demod_cuda

    lib = demod_cuda.cuda_library()
    times = []

    def launch(args):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        demod_cuda.launch_kernel(lib, args)
        end.record()
        times.append((start, end))

    for _ in range(reps + 1):
        demod_cuda.run_with(launch, lib, params, state, mags, iqs, fm_quadri=False, with_ctcss=with_ctcss, with_iq=False)
    torch.cuda.synchronize()
    return min(s.elapsed_time(e) for s, e in times[1:])


def phase_main_path(device, card: str) -> dict:
    """The port's main path at full width, then its timings."""
    import torch

    from rtlsdr_airband_tpu_torch.models.flagship import build_flagship
    from rtlsdr_airband_tpu_torch.ops import demod_cuda
    from rtlsdr_airband_tpu_torch.ops.channelizer import channelize_matmul
    from rtlsdr_airband_tpu_torch.ops.demod import demod_block

    block, x, state0 = build_flagship(n_channels=C_FLAGSHIP, wave_rate=16000, device=device)
    kw = block.block_kwargs
    W, hop = kw["n_frames"], kw["hop"]
    rng = np.random.default_rng(7)
    noise = torch.as_tensor(rng.normal(0, 0.01, (K_BLOCKS,) + tuple(x.shape)).astype(np.float32), device=device)
    xs = [x + noise[k] for k in range(K_BLOCKS)]  # K distinct blocks

    def run_chain(states_in=None):
        st, outs = state0, []
        for xb in xs:
            if states_in is not None:
                states_in.append(st)
            st, out = block(xb, st)
            outs.append(out)
        return st, outs

    states_in = []
    demod_cuda.LAUNCHES = 0
    _, outs = run_chain(states_in)
    torch.cuda.synchronize()
    launches = demod_cuda.LAUNCHES
    if launches != K_BLOCKS:
        raise AssertionError(f"main path launched K1 {launches} times for {K_BLOCKS} blocks")
    for k, out in enumerate(outs):
        if tuple(out["audio"].shape) != (W, C_FLAGSHIP) or not bool(torch.isfinite(out["audio"]).all()):
            raise AssertionError(f"main path block {k}: audio not finite or misshapen")
        for key in ("signal_level", "noise_level", "squelch_level"):
            if not bool(torch.isfinite(out[key]).all()):
                raise AssertionError(f"main path block {k}: {key} not finite")
    active = [int(out["active"].sum().item()) for out in outs]
    log(f"main path: {K_BLOCKS} blocks, K1 launches {launches}, outputs finite, channels active per block {active}")

    # ---- timings, on the main path's own blocks and states ----
    block_ms = time_ms(run_chain, reps=3) / K_BLOCKS
    block_s = block_ms / 1e3
    params = block.params
    taps = (block.taps_re, block.taps_im)
    inputs = [channelize_matmul(xb, block.bins, block.window, hop=hop, fft_size=kw["fft_size"], n_frames=W, taps=taps) for xb in xs]
    gemm_ms = time_ms(lambda: channelize_matmul(xs[0], block.bins, block.window, hop=hop, fft_size=kw["fft_size"], n_frames=W, taps=taps), reps=10)
    k1_per_block = [kernel_ms(params, st, m, q, reps=3) for st, (m, q) in zip(states_in, inputs)]
    k1_mean = sum(k1_per_block) / K_BLOCKS
    # the same without the Goertzel banks: how much of K1 the CTCSS channels cost
    k1_no_ctcss = [kernel_ms(params, st, m, q, reps=3, with_ctcss=False) for st, (m, q) in zip(states_in, inputs)]
    last_mags, last_iqs = inputs[-1]
    plain_ms = time_ms(lambda: demod_block(params, states_in[-1], last_mags, last_iqs), reps=1, warmup=0)
    bound_ms, bound_by, how = demod_bound(params, states_in[-1], last_mags)
    t = dict(
        block_ms=block_ms,
        channel_msps=C_FLAGSHIP * W * hop / block_s / 1e6,
        realtime_factor=(W / 16000) / block_s,
        k1_ms=k1_mean,
        gemm_ms=gemm_ms,
        plain_ms=plain_ms,
        bound_ms=bound_ms,
        bound_by=bound_by,
        launches=launches,
    )
    log(f"K1 alone per main-path block (ms): {' '.join(f'{v:.3f}' for v in k1_per_block)}")
    log(f"K1 alone without the CTCSS banks (with_ctcss=False), per block (ms): {' '.join(f'{v:.3f}' for v in k1_no_ctcss)}")
    log(f"K1 bound ({bound_by}): {how}")
    gemm_flop = 4 * 2 * W * kw["fft_size"] * C_FLAGSHIP
    log(f"channelizer GEMMs' bound (operations): 4 x 2*W*N*C = {gemm_flop} flop / 67 TFLOP/s = {gemm_flop / FP32_FLOPS * 1e3:.4f} ms")
    profile_chain(run_chain, card)
    log(
        f"timing [{card}]: block_ms {block_ms:.3f} channel_msps {t['channel_msps']:.1f} realtime_factor {t['realtime_factor']:.2f} "
        f"k1_ms {k1_mean:.3f} gemm_ms {gemm_ms:.3f} plain_demod_ms {plain_ms:.1f} k1_bound_ms {bound_ms:.4f}"
    )
    return t


def profile_chain(run_chain, card: str) -> None:
    """Device time of the K-block main path by kernel, from torch.profiler,
    and the device's busy share of the wall time (the profiler's own cost
    included).  A profiler that records no device time is reported."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_chain()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [
        (e.key, e.device_time_total / 1e3, e.count)
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and e.device_time_total > 0
    ]
    if not rows:
        log("profile: torch.profiler recorded no device time")
        return
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    log(f"profile of {K_BLOCKS} main-path blocks [{card}]: device busy {busy:.3f} ms of {wall_ms:.3f} ms wall "
        f"({100 * busy / wall_ms:.1f}%, profiler on); by kernel:")
    for key, ms, n in rows[:10]:
        log(f"  {ms:9.3f} ms  x{n:<4d} {key[:110]}")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        from rtlsdr_airband_tpu_torch import _build
    except ImportError as e:
        print(f"chip_smoke: the port's package is missing ({e})", file=sys.stderr)
        return 1

    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    card = card_line()
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; nvidia-smi: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    built = _build.build_kernels()
    for src, b in built.items():
        regs = [ln.strip() for ln in b.log.splitlines() if "registers" in ln or "spill" in ln]
        log(f"build {src}: {b.seconds:.1f} s -> {b.path.name}; " + " | ".join(regs))
    log(f"build total: {time.perf_counter() - t0:.1f} s")

    err = phase_parity(device)
    phase_snr(device)
    t = phase_main_path(device, card)

    log(f"kernels: K1 demod (csrc/demod.cu) launches {t['launches']} parity ok "
        f"(audio {err['audio']:.3e}, iq {err['iq']:.3e}, flags exact, int/bool state exact, bit for bit: {err['bitwise']})")
    log(json.dumps({"kernels": [{
        "name": "demod",
        "route": "cuda",
        "source": "rtlsdr_airband_tpu_torch/csrc/demod.cu",
        "replaces": "rtlsdr_airband_tpu/ops/demod_pallas.py:848",
        "launches": t["launches"],
        "max_abs_err": err["audio"],
        "ms": t["k1_ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": None,
    }]}))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
