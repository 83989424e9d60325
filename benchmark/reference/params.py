"""Host-side construction of ChannelParams / DemodState from channel configs.

A frozen copy of the port's ``ops/params.py``: builds the
[C]-vectorized parameter tensors consumed by ``ops.demod`` and
``ops.demod_cuda`` from per-channel configuration (the fields parse_channels
fills in the reference: config.cpp:306-726).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .constants import AGC_EXTRA
from .demod import CLOSED, SQ_BUF, ChannelParams, CtcssState, DemodState
from .filters import design_bessel_lowpass, design_notch
from .goertzel import MAX_TONES, build_ctcss_banks
from .levels import dbfs_to_level
from .sincos import compute_dm_dphi, make_sincos_tables


@dataclass
class ChannelSpec:
    """One demodulated channel (mirrors the reference's channel+freq config,
    config.cpp:306-726)."""

    frequency: int = 0
    modulation: str = "am"  # 'am' | 'nfm'
    label: str | None = None
    ampfactor: float = 1.0
    bandwidth: float = 0.0  # lowpass bandwidth Hz (0 = disabled)
    notch: float = 0.0
    notch_q: float = 10.0
    ctcss: float = 0.0
    squelch_threshold_dbfs: float | None = None  # manual (dBFS)
    squelch_snr_threshold_db: float | None = None
    has_iq_outputs: bool = False
    tau_us: float | None = None
    afc: int = 0

    @property
    def needs_raw_iq(self) -> bool:
        return self.modulation == "nfm" or self.bandwidth > 0 or self.has_iq_outputs


def cost_group_permutation(specs: list[ChannelSpec]) -> np.ndarray:
    """Stable permutation grouping channels by DSP cost class.

    Grouping CTCSS channels (and, secondarily, the other gated features) into
    contiguous runs keeps the demod kernel's warps uniform on its per-channel
    branches.  Order within a class is preserved (stable sort); callers
    inverse-permute per-channel outputs back to user order.
    """
    key = np.array(
        [
            ((s.ctcss > 0) << 3) | (s.needs_raw_iq << 2) | ((s.modulation == "nfm") << 1) | (s.notch > 0)
            for s in specs
        ],
        np.int64,
    )
    return np.argsort(key, kind="stable").astype(np.int32)


def make_channel_params(
    specs: list[ChannelSpec],
    *,
    wave_rate: int,
    sample_rate: int,
    center_freq: int,
    fft_size: int,
    device="cuda",
) -> ChannelParams:
    C = len(specs)
    T = MAX_TONES

    def dev(a):
        return torch.as_tensor(np.asarray(a), device=device)

    def arr(fn, dtype=np.float32):
        return dev(np.array([fn(s) for s in specs], dtype=dtype))

    is_nfm = arr(lambda s: s.modulation == "nfm", bool)
    needs_raw_iq = arr(lambda s: s.needs_raw_iq, bool)
    has_iq_outputs = arr(lambda s: s.has_iq_outputs, bool)
    # < 2^24, so int32 holds it exactly
    dm_dphi = arr(lambda s: (compute_dm_dphi(s.frequency, center_freq, sample_rate, wave_rate) & 0xFFFFFF) if s.needs_raw_iq else 0, np.int32)

    def alpha_of(s: ChannelSpec) -> float:
        tau = 200.0 if s.tau_us is None else s.tau_us
        return 0.0 if tau == 0 else float(np.exp(-1.0 / (wave_rate * 1e-6 * tau)))

    alpha = arr(alpha_of)
    ampfactor = arr(lambda s: s.ampfactor)

    using_manual = arr(lambda s: s.squelch_threshold_dbfs is not None, bool)
    manual_level = arr(lambda s: dbfs_to_level(s.squelch_threshold_dbfs, fft_size) if s.squelch_threshold_dbfs is not None else -1.0)
    snr_db = [9.54 if s.squelch_snr_threshold_db is None else s.squelch_snr_threshold_db for s in specs]
    normal_ratio = np.array([np.float32(10.0 ** (db / 20.0)) for db in snr_db], dtype=np.float32)
    flappy_ratio = normal_ratio * np.float32(0.9)

    lp = [design_bessel_lowpass(s.bandwidth / 2.0 if s.bandwidth > 0 else 0.0, wave_rate) for s in specs]
    notch = [design_notch(s.notch, wave_rate, s.notch_q) for s in specs]

    fastc = np.zeros((T, C), np.float32)
    fastm = np.zeros((T, C), bool)
    fastw = np.ones(C, np.int32)
    fastn = np.ones(C, np.float32)
    slowc = np.zeros((T, C), np.float32)
    slowm = np.zeros((T, C), bool)
    sloww = np.ones(C, np.int32)
    slown = np.ones(C, np.float32)
    ctcss_en = np.zeros(C, bool)
    for i, s in enumerate(specs):
        if s.ctcss > 0:
            fast, slow = build_ctcss_banks(s.ctcss, wave_rate)
            ctcss_en[i] = True
            fastc[:, i] = fast.coeffs
            fastm[:, i] = fast.mask
            fastw[i] = fast.window_size
            fastn[i] = fast.mask.sum()
            slowc[:, i] = slow.coeffs
            slowm[:, i] = slow.mask
            sloww[i] = slow.window_size
            slown[i] = slow.mask.sum()

    sin_lut, cos_lut = make_sincos_tables()

    return ChannelParams(
        is_nfm=is_nfm,
        needs_raw_iq=needs_raw_iq,
        has_iq_outputs=has_iq_outputs,
        dm_dphi=dm_dphi,
        alpha=alpha,
        ampfactor=ampfactor,
        using_manual=using_manual,
        manual_level=manual_level,
        normal_ratio=dev(normal_ratio),
        flappy_ratio=dev(flappy_ratio),
        lp_enabled=dev(np.array([f.enabled for f in lp])),
        lp_gain=dev(np.array([f.gain for f in lp], np.float32)),
        lp_y0=dev(np.array([f.ycoeff0 for f in lp], np.float32)),
        lp_y1=dev(np.array([f.ycoeff1 for f in lp], np.float32)),
        notch_enabled=dev(np.array([f.enabled for f in notch])),
        notch_d0=dev(np.array([f.d0 for f in notch], np.float32)),
        notch_d1=dev(np.array([f.d1 for f in notch], np.float32)),
        notch_d2=dev(np.array([f.d2 for f in notch], np.float32)),
        ctcss_enabled=dev(ctcss_en),
        fast_coeff=dev(fastc),
        fast_mask=dev(fastm),
        fast_window=dev(fastw),
        fast_ntones=dev(fastn),
        slow_coeff=dev(slowc),
        slow_mask=dev(slowm),
        slow_window=dev(sloww),
        slow_ntones=dev(slown),
        sin_lut=dev(sin_lut),
        cos_lut=dev(cos_lut),
    )


def init_demod_state(C: int, prime_mags: torch.Tensor, prime_iqs: torch.Tensor) -> DemodState:
    """Initial carried state (reference inits: squelch.cpp:36-84,
    config.cpp:270-330), on the device of ``prime_mags``.  ``prime_mags``
    [A, C] / ``prime_iqs`` [A, C, 2] are the first AGC_EXTRA channelizer
    outputs that seed the wavein delay line and IQ tail."""
    A = AGC_EXTRA
    device = prime_mags.device

    def full(shape, v, dtype):
        return torch.full(shape, v, dtype=dtype, device=device)

    f = lambda v: full((C,), v, torch.float32)  # noqa: E731
    i = lambda v: full((C,), v, torch.int32)  # noqa: E731
    b = lambda v: full((C,), v, torch.bool)  # noqa: E731

    def ct():
        return CtcssState(
            q1=full((MAX_TONES, C), 0.0, torch.float32),
            q2=full((MAX_TONES, C), 0.0, torch.float32),
            count=i(0),
            enough=b(False),
            has_tone=b(False),
            found=i(0),
            not_found=i(0),
        )

    return DemodState(
        noise_floor=f(5.0),
        pre_full=f(0.001),
        pre_capped=f(0.001),
        post_full=f(0.001),
        post_capped=f(0.001),
        using_post_filter=b(False),
        cur=i(CLOSED),
        nxt=i(CLOSED),
        delay=i(0),
        low_signal_count=i(0),
        sample_count=i(-1),
        open_count=i(0),
        flappy_count=i(0),
        recent_open_count=i(0),
        closed_sample_count=i(0),
        sq_buffer=full((SQ_BUF, C), 0.0, torch.float32),
        lp_xr=full((3, C), 0.0, torch.float32),
        lp_xi=full((3, C), 0.0, torch.float32),
        lp_yr=full((3, C), 0.0, torch.float32),
        lp_yi=full((3, C), 0.0, torch.float32),
        notch_x=full((3, C), 0.0, torch.float32),
        notch_y=full((3, C), 0.0, torch.float32),
        agc=f(0.5),
        dm_phi=i(0),
        pr=f(0.0),
        pj=f(0.0),
        prev_waveout=f(0.5),
        fast=ct(),
        slow=ct(),
        wavein_delay=prime_mags.to(torch.float32).clone(),
        iq_tail=prime_iqs.to(torch.float32).clone(),
        waveout_tail=full((A, C), 0.5, torch.float32),
    )
