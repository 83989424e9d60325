"""Synthetic signal generation for tests and golden harnesses.

Vectorized analog of the reference's test harness (src/generate_signal.cpp):
sums of sinusoids plus seeded gaussian noise (sigma 0.1 scaled by amplitude).
Also provides IQ scene synthesis: place modulated carriers at channel offsets
within a wideband complex baseband capture, for end-to-end channelizer tests.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# Amplitude presets (reference: generate_signal.cpp:26-39)
TONE_WEAK, TONE_NORMAL, TONE_STRONG = 0.05, 0.2, 0.4
NOISE_WEAK, NOISE_NORMAL, NOISE_STRONG = 0.05, 0.2, 0.5


@dataclass
class SignalGen:
    """Audio-rate scalar signal: tones + gaussian noise."""

    sample_rate: int
    tones: list[tuple[float, float]] = field(default_factory=list)  # (freq, ampl)
    noise_ampl: float = 0.0
    seed: int = 0

    def add_tone(self, freq: float, ampl: float) -> "SignalGen":
        self.tones.append((freq, ampl))
        return self

    def add_noise(self, ampl: float) -> "SignalGen":
        self.noise_ampl = ampl
        return self

    def render(self, n_samples: int, start_sample: int = 0) -> np.ndarray:
        # Tone phase matches the reference: sample_count starts at 1.
        n = np.arange(start_sample + 1, start_sample + n_samples + 1, dtype=np.float64)
        out = np.zeros(n_samples, dtype=np.float32)
        for freq, ampl in self.tones:
            out += (ampl * np.sin(2 * np.pi * n * freq / self.sample_rate)).astype(np.float32)
        if self.noise_ampl > 0.0:
            rng = np.random.default_rng(self.seed + start_sample)
            out += (self.noise_ampl * rng.normal(0.0, 0.1, n_samples)).astype(np.float32)
        return out


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

    ``audio`` is at ``audio_rate`` (default sample_rate/320-ish); it is
    zero-order-hold upsampled to the IQ rate.
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
    # Keep the phase accumulator in float64 and split out the linear carrier
    # term so the cumulative sum stays small enough for full precision.
    phase = 2 * np.pi * (offset_hz * n + np.cumsum(inst)) / sample_rate
    return (carrier_ampl * np.exp(1j * phase)).astype(np.complex64)


def complex_noise(n_samples: int, sigma: float, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (sigma * (rng.normal(size=n_samples) + 1j * rng.normal(size=n_samples)) / np.sqrt(2)).astype(
        np.complex64
    )


def iq_to_u8(iq: np.ndarray) -> np.ndarray:
    """Encode complex64 IQ (|x|<=1) into interleaved CU8 bytes."""
    inter = np.empty(2 * len(iq), dtype=np.float32)
    inter[0::2] = iq.real
    inter[1::2] = iq.imag
    return np.clip(np.round(inter * 127.5 + 127.5), 0, 255).astype(np.uint8)
