"""Synthetic IQ scene generation (numpy): modulated carriers at channel
offsets within a wideband complex baseband capture, plus seeded noise."""

from __future__ import annotations

import numpy as np


def am_carrier_iq(
    sample_rate: int,
    offset_hz: float,
    n_samples: int,
    audio: np.ndarray | None = None,
    carrier_ampl: float = 0.5,
    mod_index: float = 0.8,
    audio_rate: int | None = None,
    start_sample: int = 0,
) -> np.ndarray:
    """Complex AM carrier at ``offset_hz`` from the capture center.

    ``audio`` is at ``audio_rate``; it is zero-order-hold upsampled to the IQ
    rate.
    """
    n = np.arange(start_sample, start_sample + n_samples, dtype=np.float64)
    if audio is None:
        env = np.ones(n_samples)
    else:
        audio_rate = audio_rate or sample_rate
        idx = np.minimum((n * audio_rate / sample_rate).astype(np.int64), len(audio) - 1)
        env = 1.0 + mod_index * audio[idx]
    ph = 2 * np.pi * offset_hz * n / sample_rate
    return (carrier_ampl * env * np.exp(1j * ph)).astype(np.complex64)


def nfm_carrier_iq(
    sample_rate: int,
    offset_hz: float,
    n_samples: int,
    audio: np.ndarray | None = None,
    deviation_hz: float = 2500.0,
    carrier_ampl: float = 0.5,
    audio_rate: int | None = None,
    start_sample: int = 0,
) -> np.ndarray:
    """Complex NFM carrier: frequency modulated by ``audio``."""
    n = np.arange(start_sample, start_sample + n_samples, dtype=np.float64)
    if audio is None:
        inst = np.zeros(n_samples)
    else:
        audio_rate = audio_rate or sample_rate
        idx = np.minimum((n * audio_rate / sample_rate).astype(np.int64), len(audio) - 1)
        inst = deviation_hz * audio[idx].astype(np.float64)
    # float64 phase accumulator with the linear carrier term split out
    phase = 2 * np.pi * (offset_hz * n + np.cumsum(inst)) / sample_rate
    return (carrier_ampl * np.exp(1j * phase)).astype(np.complex64)


def complex_noise(n_samples: int, sigma: float, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (sigma * (rng.normal(size=n_samples) + 1j * rng.normal(size=n_samples)) / np.sqrt(2)).astype(
        np.complex64
    )
