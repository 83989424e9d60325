"""Channelizer: batched sliding-window DFT at the channels' bins.

Counterpart of ``rtlsdr_airband_tpu/ops/channelizer.py``.  The reference
computes one size-N windowed FFT per output audio sample and takes a single
bin per channel (reference: src/rtl_airband.cpp:394,457-490; hop =
round(sample_rate / wave_rate)).  Two equivalent paths:

 - ``channelize_matmul`` (the default): since only C bins are consumed, the
   windowed DFT at those bins is a complex product ``frames @ taps^H`` with
   taps[c, n] = window[n] * exp(-2*pi*i*bin_c*n/N): four real float32 GEMMs,
   left to ``torch.matmul``;
 - ``channelize_fft``: the full windowed FFT of every frame
   (``torch.fft.fft``, complex64) and a gather at the bins.

``last_frame_spectrum_power`` is the spectrum the host's AFC reads.

Precision: the GEMMs must run in full float32.  TF32 (about three decimal
digits) falls below the >= 80 dB SNR the end-to-end audio needs, so
``channelize_matmul`` turns TF32 off for CUDA matmuls explicitly.

IQ crosses every function boundary as float32 with a trailing dimension of 2
(..., [re, im]), as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch


def block_input_len(n_frames: int, hop: int, fft_size: int) -> int:
    """Raw IQ samples needed to produce ``n_frames`` channelizer outputs."""
    return (n_frames - 1) * hop + fft_size


def make_frames(x: torch.Tensor, hop: int, fft_size: int, n_frames: int) -> torch.Tensor:
    """[L, 2] -> [n_frames, fft_size, 2] overlapped frames, frame g starting at
    g*hop: a strided view of ``x`` (no copy) when ``x`` is long enough."""
    need = block_input_len(n_frames, hop, fft_size)
    if x.shape[0] < need:
        pad = torch.zeros((need - x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
        x = torch.cat([x, pad], dim=0)
    x = x.contiguous()
    s0 = x.stride(0)
    return x.as_strided((n_frames, fft_size) + tuple(x.shape[1:]), (hop * s0, s0) + tuple(x.stride()[1:]))


def make_taps(bins: torch.Tensor, window: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Matched-filter taps taps[c, n] = window[n] * exp(-2*pi*i * bin_c * n / N).

    Returns (real, imag) each [C, N] float32.
    """
    n = window.shape[0]
    # bin*k mod N keeps angles in [0, 2*pi) for full f32 precision
    phase_idx = (bins[:, None].to(torch.int32) * torch.arange(n, dtype=torch.int32, device=bins.device)[None, :]) % n
    ang = float(np.float32(-2.0 * np.pi / n)) * phase_idx.to(torch.float32)
    w = window[None, :].to(torch.float32)
    return torch.cos(ang) * w, torch.sin(ang) * w


def channelize_matmul(
    x: torch.Tensor,
    bins: torch.Tensor,
    window: torch.Tensor,
    *,
    hop: int,
    fft_size: int,
    n_frames: int,
    taps: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Windowed DFT at C bins via four float32 GEMMs.

    x: [L, 2] f32 baseband block (re/im pairs); bins: [C] int32; window: [N] f32.
    Returns (mags [n_frames, C] f32, iq [n_frames, C, 2] f32).

    ``taps``: optional precomputed ``make_taps(bins, window)`` result (bins
    change only on retune, so streaming callers compute taps once).
    """
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    frames = make_frames(x, hop, fft_size, n_frames)  # [W, N, 2] view
    fr, fi = frames[..., 0], frames[..., 1]
    tr, ti = taps if taps is not None else make_taps(bins, window)
    # (fr + i*fi) @ (tr + i*ti)^T
    yr = torch.matmul(fr, tr.T) - torch.matmul(fi, ti.T)
    yi = torch.matmul(fr, ti.T) + torch.matmul(fi, tr.T)
    mags = torch.sqrt(yr * yr + yi * yi)
    return mags, torch.stack([yr, yi], dim=-1)


def channelize_fft(
    x: torch.Tensor, bins: torch.Tensor, window: torch.Tensor, *, hop: int, fft_size: int, n_frames: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched-FFT channelizer: the full [n_frames, N] complex64 spectra
    (``torch.fft.fft``, cuFFT on the card), then the gather at the channels'
    bins.  Complex exists only inside the function.  Same arguments and
    returns as :func:`channelize_matmul`, without ``taps``."""
    frames = make_frames(x, hop, fft_size, n_frames) * window[:, None]  # [W, N, 2], contiguous
    spec = torch.fft.fft(torch.view_as_complex(frames))
    sel = torch.view_as_real(spec[:, bins.long()])  # [W, C, 2]
    yr, yi = sel[..., 0], sel[..., 1]
    return torch.sqrt(yr * yr + yi * yi), sel.contiguous()


def last_frame_spectrum_power(x: torch.Tensor, window: torch.Tensor, *, hop: int, fft_size: int, n_frames: int) -> torch.Tensor:
    """|X|^2 [N] of the block's last frame, for the host's AFC (reference:
    rtl_airband.cpp:180-251 hill-climbs adjacent FFT bins on the most recent
    FFT output).  x: [L, 2] f32 pairs."""
    start = (n_frames - 1) * hop
    frame = x[start : start + fft_size] * window[:, None]
    spec = torch.view_as_real(torch.fft.fft(torch.view_as_complex(frame)))
    return spec[:, 0] ** 2 + spec[:, 1] ** 2


def decode_raw_iq(raw: torch.Tensor, sfmt: str, fullscale: float) -> torch.Tensor:
    """Sample-format decode to f32 IQ pairs (reference LUT/scale semantics,
    rtl_airband.cpp:316-324,402-455; all four formats are affine).

    raw: u8 [2L] (u8/s8), int16 [2L], or f32 [2L] interleaved IQ.
    Returns [L, 2] float32.
    """
    if sfmt == "u8":
        # a true divide (by a tensor: PyTorch turns division by a Python
        # scalar into a multiply by its reciprocal on the GPU), bit-identical
        # to the host LUT the golden chain is pinned to; the divisor is
        # filled on the device, since a copy from the host would make the
        # host wait for the device's queue every block
        half = torch.full((), 127.5, dtype=torch.float32, device=raw.device)
        v = (raw.to(torch.float32) - 127.5) / half
    elif sfmt == "s8":
        v = raw.view(torch.int8).to(torch.float32) * (1.0 / 128.0)
    elif sfmt == "s16":
        v = raw.to(torch.float32) * (1.0 / fullscale)
    elif sfmt == "f32":
        v = raw.to(torch.float32) * (1.0 / fullscale)
    else:
        raise ValueError(f"unknown sample format {sfmt}")
    return v.reshape(-1, 2)
