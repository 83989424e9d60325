"""Shared inputs and parity bars of the port's tests (tests/test_torch_*.py).

Imports neither jax nor the JAX package, so tests/test_torch_cuda.py can
use it on a machine without JAX.
"""

import numpy as np
import torch

from rtlsdr_airband_tpu_torch import interop
from rtlsdr_airband_tpu_torch.constants import AGC_EXTRA
from rtlsdr_airband_tpu_torch.ops.demod import OPEN
from rtlsdr_airband_tpu_torch.ops.params import init_demod_state

FS, N, CENTER = 2_560_000, 512, 120_000_000

SPEC_KW = [  # tests/test_demod_pallas.py::SPECS, as keyword sets for both packages
    dict(frequency=120_400_000, modulation="am"),
    dict(frequency=120_500_000, modulation="am", bandwidth=6000, notch=1000.0, has_iq_outputs=True),
    dict(frequency=120_600_000, modulation="nfm", bandwidth=8000),
    dict(frequency=120_700_000, modulation="nfm", ctcss=100.0),
    dict(frequency=120_800_000, modulation="am", squelch_threshold_dbfs=-40.0),
    dict(frequency=120_900_000, modulation="am", ampfactor=1.3),
]


def spec_population(C: int) -> list[dict]:
    """C channels cycling through SPEC_KW's six kinds from the CTCSS one
    (so C = 3 has one too), 13 kHz apart inside the band (C <= 170)."""
    return [dict(SPEC_KW[(i + 3) % len(SPEC_KW)], frequency=119_000_000 + 13_000 * i) for i in range(C)]


# Bars as in tests/test_demod_pallas.py:94-97: audio, IQ and float state
# within 1e-4 absolute; flags and int/bool state exact.
ATOL = 1e-4

# The Goertzel accumulators grow to hundreds within a window (resonators with
# coefficients near 2), where one float32 ulp is ~3e-5 and the rounding of
# hundreds of steps adds up.  The JAX package's own two versions disagree
# there by more than 1e-4 (test_torch_demod.py::
# test_bank_bar_is_the_jax_packages_own_spread).  So these leaves are held to
# 1e-4 of the largest magnitude in their channel's bank, the scale their
# rounding follows; every other float leaf is held to 1e-4 absolute.
BANK_ACCUMULATORS = ("fast.q1", "fast.q2", "slow.q1", "slow.q2")


def jax_flat(st) -> dict:
    """A JAX DemodState as a flat dict of numpy arrays, keyed as
    ``rtlsdr_airband_tpu_torch.interop`` keys it."""
    out = {}
    for name in st._fields:
        v = getattr(st, name)
        if hasattr(v, "_fields"):
            for sub in v._fields:
                out[f"{name}.{sub}"] = np.asarray(getattr(v, sub))
        else:
            out[name] = np.asarray(v)
    return out


def dft_at_bins(x, bins, window, *, hop: int, fft_size: int, n_frames: int) -> np.ndarray:
    """The channelizer's exact value: the windowed DFT of each frame at each
    channel's bin, in float64.  x: [L, 2].  Returns complex128 [n_frames, C]."""
    x = np.asarray(x, np.float64)
    frames = x[np.arange(n_frames)[:, None] * hop + np.arange(fft_size)[None, :]]
    z = (frames[..., 0] + 1j * frames[..., 1]) * np.asarray(window, np.float64)[None, :]
    return z @ np.exp(-2j * np.pi * np.outer(np.arange(fft_size), np.asarray(bins)) / fft_size)


def snr_db(got: np.ndarray, ref: np.ndarray) -> float:
    """10 log10(sum |ref|^2 / sum |got - ref|^2), in float64."""
    err = np.sum(np.abs(np.asarray(got, np.complex128) - ref) ** 2)
    return float("inf") if err == 0 else float(10 * np.log10(np.sum(np.abs(ref) ** 2) / err))


# The channelizer's bar, the one the end-to-end audio needs (ROADMAP.md,
# "Parity bars"): at least 80 dB SNR against the float64 DFT.
CHANNELIZER_SNR_DB = 80.0


def assert_channelizer_close(mags, iq, ref: np.ndarray, label: str) -> None:
    """A float32 channelizer output (mags [W, C], iq [W, C, 2]) against the
    float64 value ``ref`` (complex [W, C]) within the channelizer's bar."""
    mags, iq = (a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a) for a in (mags, iq))
    for name, got, want in (("iq", iq[..., 0] + 1j * iq[..., 1], ref), ("mags", mags, np.abs(ref))):
        db = snr_db(got, want)
        assert db >= CHANNELIZER_SNR_DB, f"{label}: {name} SNR {db:.1f} dB < {CHANNELIZER_SNR_DB} dB"


def assert_close(want: dict, got: dict, label: str) -> None:
    """Every key of ``want`` against ``got`` (numpy arrays or tensors) within
    the bars: same shape and dtype, ints and bools exact, floats within
    ATOL with NaN at the same places."""
    assert want.keys() <= got.keys(), label
    for k in want:
        a, b = np.asarray(want[k]), got[k]
        b = b.detach().cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, f"{label}: {k} {a.dtype}{a.shape} vs {b.dtype}{b.shape}"
        if a.dtype.kind in "iub":
            assert np.array_equal(a, b), f"{label}: {k} mismatch"
            continue
        assert np.array_equal(np.isnan(a), np.isnan(b)), f"{label}: {k} NaN positions"
        d = np.nan_to_num(np.abs(a.astype(np.float64) - b))
        if k in BANK_ACCUMULATORS:
            d = d / np.maximum(1.0, np.abs(a.astype(np.float64)).max(axis=0))
        assert d.max() <= ATOL, f"{label}: {k} maxdiff {d.max():.3e}"


def active_state(params, C: int, rng, device):
    """Low noise floor, high signal averages and the CTCSS channels OPEN with
    both Goertzel windows nearly full, so one short run opens and closes
    squelches, and the banks decide, latch and reset (as in
    tests/test_torch_demod.py)."""
    st = init_demod_state(
        C,
        torch.from_numpy(np.abs(rng.normal(0, 1.0, (AGC_EXTRA, C))).astype(np.float32)),
        torch.from_numpy(rng.normal(0, 0.5, (AGC_EXTRA, C, 2)).astype(np.float32)),
    )
    d = interop.state_to_numpy(st)
    ct = params.ctcss_enabled.cpu().numpy()
    d["noise_floor"] = np.full(C, 0.3, np.float32)
    d["pre_full"] = d["pre_capped"] = np.full(C, 1.2, np.float32)
    d["cur"] = d["nxt"] = np.where(ct, OPEN, d["cur"]).astype(np.int32)
    for bank, left in (("fast", 40), ("slow", 100)):
        d[f"{bank}.count"] = np.where(ct, getattr(params, f"{bank}_window").cpu().numpy() - left, 0).astype(np.int32)
    return interop.state_from_numpy(d, device=device)


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def assert_bitwise(want_out, got_out, label: str) -> None:
    """Two demod_block returns (state, audio, iq, flags) equal bit for bit:
    every output and every state leaf, floats compared as their bits (so a
    NaN must sit at the same place with the same payload)."""
    for name, x, y in zip(("audio", "iq", "flags"), want_out[1:], got_out[1:]):
        assert x.shape == y.shape and torch.equal(_bits(x.cpu()), _bits(y.cpu())), f"{label}: {name} differs"
    want, got = interop.state_to_numpy(want_out[0]), interop.state_to_numpy(got_out[0])
    assert want.keys() == got.keys(), label
    for k in want:
        a, b = want[k], got[k]
        assert a.dtype == b.dtype and a.shape == b.shape, f"{label}: state {k} {a.dtype}{a.shape} vs {b.dtype}{b.shape}"
        assert a.tobytes() == b.tobytes(), f"{label}: state {k} differs"
