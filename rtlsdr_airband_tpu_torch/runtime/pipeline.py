"""Block program: raw IQ in -> per-channel audio block out.

Counterpart of the non-mesh branch of
``rtlsdr_airband_tpu/runtime/pipeline.py::_pipeline_block_impl``: decode,
matched-filter channelizer, demod recurrence, then the user-order restore
and the per-channel observability snapshots (reference:
src/rtl_airband.cpp:286-672 for one WAVE_BATCH block).
"""

from __future__ import annotations

import torch

from ..ops.channelizer import channelize_matmul, decode_raw_iq
from ..ops.demod import ChannelParams, DemodState, _levels, demod_block
from ..ops.demod_cuda import demod_block_cuda


def channelize_block(x, bins, window, *, hop, fft_size, n_frames, taps=None):
    """The block program's channelizer step: (mags [W, C], iq [W, C, 2]).
    The matched-filter path only; the FFT path is not ported yet."""
    return channelize_matmul(x, bins, window, hop=hop, fft_size=fft_size, n_frames=n_frames, taps=taps)


def _state_meta(params: ChannelParams, state: DemodState):
    """(squelch_level, sig_outside) snapshots from a carried state (device
    channel order): Squelch::squelch_level() (squelch.cpp:164-177) and
    signal_outside_filter() (squelch.cpp:152-154)."""
    squelch_level = _levels(params, state.noise_floor, state.recent_open_count)
    sig_outside = state.using_post_filter & (state.pre_capped >= squelch_level) & (state.post_capped < state.sq_buffer[0])
    return squelch_level, sig_outside


def pipeline_block(
    x: torch.Tensor,  # [L, 2] f32 IQ pairs, or [2L] raw when sample_fmt is set
    bins: torch.Tensor,  # [C] int32 FFT bin per channel
    window: torch.Tensor,  # [N] f32
    params: ChannelParams,
    state: DemodState,
    *,
    hop: int,
    fft_size: int,
    n_frames: int,
    fm_quadri: bool = False,
    with_ctcss: bool = True,
    with_iq: bool = True,
    demod_backend: str = "cuda",
    sample_fmt: str = "pairs",
    fullscale: float = 1.0,
    taps: tuple[torch.Tensor, torch.Tensor] | None = None,
    inv_perm: torch.Tensor | None = None,
):
    """Fused channelize + demod for one block; returns (state', outputs).

    demod_backend: 'cuda' (the kernel for CUDA tensors, the plain version for
    CPU tensors) or 'plain' (the plain PyTorch version on either device).
    with_iq=False elides the per-sample IQ-tap output.  sample_fmt: 'pairs'
    (x is [L, 2] f32) or 'u8'/'s8'/'s16'/'f32' raw interleaved IQ decoded on
    the device.  taps: optional precomputed ``make_taps(bins, window)``.
    inv_perm: optional [C] index restoring user channel order on every
    per-channel output (channels run grouped by cost_group_permutation).
    """
    if sample_fmt != "pairs":
        x = decode_raw_iq(x, sample_fmt, fullscale)
    mags, iqs = channelize_block(x, bins, window, hop=hop, fft_size=fft_size, n_frames=n_frames, taps=taps)
    if demod_backend == "cuda":
        state, audio, iq_out, open_flags = demod_block_cuda(
            params, state, mags, iqs, fm_quadri=fm_quadri, with_ctcss=with_ctcss, with_iq=with_iq
        )
    elif demod_backend == "plain":
        state, audio, iq_out, open_flags = demod_block(params, state, mags, iqs, fm_quadri=fm_quadri, with_ctcss=with_ctcss)
    else:
        raise ValueError(f"unknown demod_backend {demod_backend!r}")
    squelch_level, sig_outside = _state_meta(params, state)
    perm = (lambda a: a[inv_perm]) if inv_perm is not None else (lambda a: a)  # noqa: E731
    if inv_perm is not None:
        audio = audio[:, inv_perm]
        open_flags = open_flags[:, inv_perm]
        iq_out = iq_out[:, inv_perm] if with_iq else iq_out
    out = dict(
        audio=audio,  # [W, C]
        iq_out=iq_out,  # [W, C, 2] f32 IQ pairs
        open_flags=open_flags,  # [W, C] bool
        active=torch.any(open_flags, dim=0),  # [C]
        signal_level=perm(state.pre_full),
        noise_level=perm(state.noise_floor),
        squelch_level=perm(squelch_level),
        sig_outside=perm(sig_outside),
        open_count=perm(state.open_count),
        flappy_count=perm(state.flappy_count),
        ctcss_found=perm(state.slow.found),
        ctcss_not_found=perm(state.slow.not_found),
    )
    return state, out
