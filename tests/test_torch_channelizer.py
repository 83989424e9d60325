"""Port parity: the channelizer of ``rtlsdr_airband_tpu_torch`` against the
JAX package's ``ops/channelizer.py`` at C=16, N=512, W=64."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtlsdr_airband_tpu.ops import channelizer as jch
from rtlsdr_airband_tpu.ops.window import blackman_harris_7
from rtlsdr_airband_tpu_torch.ops import channelizer as tch
from torch_port_common import CHANNELIZER_SNR_DB, assert_channelizer_close, dft_at_bins, snr_db

C, N, W, HOP = 16, 512, 64, 160


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    L = tch.block_input_len(W, HOP, N)
    x = rng.normal(0, 0.3, (L, 2)).astype(np.float32)
    bins = rng.integers(0, N, C).astype(np.int32)
    return x, bins, blackman_harris_7(N)


@pytest.mark.parametrize("fmt", ["u8", "s8", "s16", "f32"])
def test_decode_raw_iq_matches_jax(fmt):
    rng = np.random.default_rng(1)
    raw = {
        "u8": rng.integers(0, 256, 512).astype(np.uint8),
        "s8": rng.integers(0, 256, 512).astype(np.uint8),  # s8 travels as bytes
        "s16": rng.integers(-32768, 32768, 512).astype(np.int16),
        "f32": rng.normal(0, 1000.0, 512).astype(np.float32),
    }[fmt]
    fullscale = 32768.0 if fmt == "s16" else 1000.0
    want = np.asarray(jch.decode_raw_iq(jnp.asarray(raw), fmt, fullscale))
    got = tch.decode_raw_iq(torch.from_numpy(raw), fmt, fullscale).numpy()
    assert got.shape == want.shape == (256, 2) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_decode_rejects_unknown_format():
    with pytest.raises(ValueError):
        tch.decode_raw_iq(torch.zeros(4, dtype=torch.uint8), "cs12", 1.0)


@pytest.mark.parametrize("short", [False, True])
def test_make_frames_matches_jax(short):
    x, _, _ = _inputs()
    if short:  # shorter than the block: zero padded, as the JAX version pads
        x = x[: len(x) - 300]
    want = np.asarray(jch.make_frames(jnp.asarray(x), HOP, N, W))
    xt = torch.from_numpy(x)
    got = tch.make_frames(xt, HOP, N, W)
    assert tuple(got.shape) == want.shape == (W, N, 2)
    np.testing.assert_array_equal(got.numpy(), want)
    if not short:  # a view of the input, not a copy
        assert got.data_ptr() == xt.data_ptr()


def test_make_taps_matches_jax():
    _, bins, window = _inputs()
    jr, ji = jch.make_taps(jnp.asarray(bins), jnp.asarray(window))
    tr, ti = tch.make_taps(torch.from_numpy(bins), torch.from_numpy(window))
    # same float32 angles; the two libraries' cos/sin may differ in the last bit
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0, atol=2e-7)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=0, atol=2e-7)


def test_channelize_matmul_matches_jax_and_f64():
    x, bins, window = _inputs()
    _, jiq = jch.channelize_matmul(jnp.asarray(x), jnp.asarray(bins), jnp.asarray(window), hop=HOP, fft_size=N, n_frames=W)
    tm, tiq = tch.channelize_matmul(torch.from_numpy(x), torch.from_numpy(bins), torch.from_numpy(window), hop=HOP, fft_size=N, n_frames=W)
    assert tuple(tm.shape) == (W, C) and tuple(tiq.shape) == (W, C, 2)
    # against the float64 DFT at the bins, and against the JAX version, by
    # the channelizer's bar: >= 80 dB SNR, the bound of the E2E audio
    ref = dft_at_bins(x, bins, window, hop=HOP, fft_size=N, n_frames=W)
    assert_channelizer_close(tm, tiq, ref, "port")
    jiq = np.asarray(jiq)
    assert_channelizer_close(tm, tiq, jiq[..., 0] + 1j * jiq[..., 1].astype(np.float64), "port against jax")

    # precomputed taps give the same result
    taps = tch.make_taps(torch.from_numpy(bins), torch.from_numpy(window))
    tm2, _ = tch.channelize_matmul(torch.from_numpy(x), None, None, hop=HOP, fft_size=N, n_frames=W, taps=taps)
    assert torch.equal(tm, tm2)
    assert tch.block_input_len(W, HOP, N) == jch.block_input_len(W, HOP, N)


def test_channelize_fft_matches_jax_and_f64():
    """The FFT path (complex64 FFT of every frame, then the bin gather)
    against the float64 DFT, the JAX FFT path and the port's matched
    filter, by the channelizer's bar."""
    x, bins, window = _inputs()
    _, jiq = jch.channelize_fft(jnp.asarray(x), jnp.asarray(bins), jnp.asarray(window), hop=HOP, fft_size=N, n_frames=W)
    args = (torch.from_numpy(x), torch.from_numpy(bins), torch.from_numpy(window))
    tm, tiq = tch.channelize_fft(*args, hop=HOP, fft_size=N, n_frames=W)
    assert tuple(tm.shape) == (W, C) and tuple(tiq.shape) == (W, C, 2)
    assert tm.dtype == tiq.dtype == torch.float32 and tiq.is_contiguous()
    assert_channelizer_close(tm, tiq, dft_at_bins(x, bins, window, hop=HOP, fft_size=N, n_frames=W), "fft port")
    jiq = np.asarray(jiq)
    assert_channelizer_close(tm, tiq, jiq[..., 0] + 1j * jiq[..., 1].astype(np.float64), "fft port against jax")
    _, miq = tch.channelize_matmul(*args, hop=HOP, fft_size=N, n_frames=W)
    assert_channelizer_close(tm, tiq, miq[..., 0].numpy() + 1j * miq[..., 1].numpy().astype(np.float64), "fft against matmul")


def test_last_frame_spectrum_power_matches_jax_and_f64():
    """|X|^2 of the block's last frame (the AFC's input) against the JAX
    function and float64, at the channelizer's bar."""
    x, _, window = _inputs(seed=2)
    want = np.asarray(jch.last_frame_spectrum_power(jnp.asarray(x), jnp.asarray(window), hop=HOP, fft_size=N, n_frames=W))
    got = tch.last_frame_spectrum_power(torch.from_numpy(x), torch.from_numpy(window), hop=HOP, fft_size=N, n_frames=W)
    assert tuple(got.shape) == want.shape == (N,) and got.dtype == torch.float32
    frame = x[(W - 1) * HOP : (W - 1) * HOP + N].astype(np.float64)
    ref = np.abs(np.fft.fft((frame[:, 0] + 1j * frame[:, 1]) * window.astype(np.float64))) ** 2
    assert snr_db(got.numpy(), ref) >= CHANNELIZER_SNR_DB
    assert snr_db(got.numpy(), want.astype(np.float64)) >= CHANNELIZER_SNR_DB
