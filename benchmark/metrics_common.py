"""Arithmetic the per-layer readers share: the device's idle share, and the
least time a kernel could take on the card (its roofline) from the shapes.

Published peaks of one H100 SXM (NVIDIA's data sheet, at its full 700 W):
67 TFLOP/s float32 outside the tensor cores, 3.35 TB/s of HBM3.
"""

from __future__ import annotations

FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
DEMOD_STEP_FLOPS = 95  # float operations of K1's step a channel-sample (chip_smoke.py counts them so)


def idle_pct(ctx):
    """Share of the traced window with no kernel or copy on the card."""
    tr = ctx.trace_result
    if tr is None or not tr.found or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def device_seconds(ctx, match) -> float | None:
    """Device seconds of the traced operations whose name ``match`` accepts."""
    tr = ctx.trace_result
    if tr is None or not tr.found:
        return None
    t = sum(v[0] for name, v in tr.ops.items() if match(name))
    return t if t > 0 else None


def _bytes_of(C: int) -> tuple[int, int]:
    """(parameter bytes, carried-state bytes) of C channels, from the
    reference's own types; the state K1 carries leaves out the two tails the
    block assembles around it."""
    import torch

    from .check import state_leaves
    from .reference.params import ChannelSpec, init_demod_state, make_channel_params

    specs = [ChannelSpec(frequency=120_000_000, modulation="nfm", ctcss=100.0)] * C
    p = make_channel_params(specs, wave_rate=16000, sample_rate=2_560_000, center_freq=120_000_000, fft_size=512, device="cpu")
    st = init_demod_state(C, torch.zeros(100, C), torch.zeros(100, C, 2))
    leaves = {k: v for k, v in state_leaves(st).items() if k not in ("iq_tail", "waveout_tail")}
    return (sum(t.numel() * t.element_size() for t in p), sum(t.numel() * t.element_size() for t in leaves.values()))


def k1_bound_s(W: int, C: int, n_ctcss: int) -> float:
    """K1's least time a block: the larger of its bytes (every input read
    once: mags, the W IQ pairs, the parameters, the state; every output
    written once: the state, the audio, a flag byte) over HBM bandwidth and
    its operations (the step's, plus both Goertzel banks on every sample of
    every CTCSS channel) over float32's peak."""
    from .reference.goertzel import MAX_TONES

    (p1, s1), (p2, s2) = _bytes_of(1), _bytes_of(2)
    param_bytes = (p2 - p1) * C + (2 * p1 - p2)  # per channel, plus the shared tables
    state_bytes = (s2 - s1) * C
    nbytes = W * C * 4 + W * C * 2 * 4 + param_bytes + 2 * state_bytes + W * C * 4 + W * C
    flops = DEMOD_STEP_FLOPS * W * C + 2 * 3 * MAX_TONES * W * n_ctcss
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS)

