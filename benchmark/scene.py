"""The traffic generator: a segment of air as a raw IQ stream, made from the seed.

One general generator for every cell; a scene file, ``scenes/<name>.json``,
gives its parameters, and a cell names the scene it runs.  After ``scripts/bench_app.py::build_scene``: complex noise over
the full-scale range, and carriers on a few channels' frequencies that key on after a
quiet lead-in, their sum kept inside that range.  The segment is ``blocks``
blocks of air long and is cycled, so each carrier keys on again in every
segment, as transmissions do, and squelches open and close all through a
window.  A carrier is AM on an AM channel and FM on an NFM channel; on a
channel with a CTCSS tone its FM carries that tone too.

Scene parameters:

- ``segment_blocks``: length of the segment in blocks of W audio samples;
- ``noise_sigma``: the complex noise's RMS (each of I and Q sigma / sqrt 2);
- ``carriers``: the number of carriers, on channels spread evenly over the
  population (``numpy.linspace(0, C - 1, carriers)``);
- ``key_on``: the share of the segment before the carriers key on;
- ``am_depth``: the AM envelope's modulation depth;
- ``tone_hz`` / ``tone_step_hz``: carrier k's voice tone is tone_hz +
  tone_step_hz * pi(k), pi a permutation drawn from the seed;
- ``fm_deviation_hz``, ``fm_tone_amplitude``, ``ctcss_amplitude``: the FM
  carriers' deviation and the amplitudes of the voice and CTCSS tones.

The seed draws the noise, the carriers' phases and which tone goes to which
carrier.  The sizes, the carriers' channels and the keying times are the same
for every seed, so every seed asks for the same work.  Phases are taken from
integer sample counts modulo the sample rate, so float32 keeps them exact
over any segment length.

The air is one complex signal z of full scale 1, quantised into the
configuration's ``sample_format`` (with its ``fullscale`` where it gives
one), as the upstream devices deliver it, I then Q, little-endian:

- ``u8`` (RTL-SDR, CU8): round(127.5 z + 127.5) in [0, 255];
- ``s8`` (HackRF through SoapySDR, CS8): round(128 z) in [-128, 127];
- ``s16`` (USRP, LimeSDR, CS16): round(fullscale z) in [-32768, 32767],
  fullscale 32768 by default;
- ``f32`` (CF32): fullscale z, fullscale 1 by default.

Whatever the format, the segment is held as its raw bytes, a flat uint8
tensor; offsets below count complex samples and turn into bytes by the
format's ``BYTES_PER_SAMPLE``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .reference.channel import BYTES_PER_SAMPLE, DEFAULT_FULLSCALE, channel_frequencies, channel_spec
from .reference.constants import AGC_EXTRA


class Scene:
    """A cycled segment of raw IQ.  ``segment`` is the bytes of one segment
    (interleaved IQ in the configuration's format) as a uint8 tensor on the
    device it was made on; stream byte ``i`` is ``segment[i % len(segment)]``."""

    def __init__(self, cfg: dict, segment: torch.Tensor, hot: np.ndarray):
        self.cfg = cfg
        self.segment = segment
        self.hot = hot
        self.bps = BYTES_PER_SAMPLE[cfg.get("sample_format", "u8")]  # bytes a complex sample
        self.hop = int(round(cfg["sample_rate"] / cfg["wave_rate"]))
        self.W = cfg["wave_rate"] // 8
        self.N = cfg["fft_size"]
        self._host: np.ndarray | None = None

    @property
    def host(self) -> np.ndarray:
        if self._host is None:
            self._host = self.segment.cpu().numpy()
        return self._host

    @property
    def block_len(self) -> int:
        """Samples one block reads: W frames of fft_size, hop apart."""
        return (self.W - 1) * self.hop + self.N

    @property
    def prime_len(self) -> int:
        return (AGC_EXTRA - 1) * self.hop + self.N

    def block_offset(self, k: int) -> int:
        """Stream sample where block ``k`` (0 = the first after priming) starts."""
        return AGC_EXTRA * self.hop + k * self.W * self.hop

    def stream_bytes(self, start: int, n: int) -> np.ndarray:
        """``n`` stream bytes from byte ``start``, on the host."""
        seg = self.host
        idx = (start + np.arange(n, dtype=np.int64)) % seg.size
        return seg[idx]

    def block_bytes(self, k: int) -> np.ndarray:
        return self.stream_bytes(self.bps * self.block_offset(k), self.bps * self.block_len)

    def prime_bytes(self) -> np.ndarray:
        return self.stream_bytes(0, self.bps * self.prime_len)


def hot_channels(n_channels: int, carriers: int) -> np.ndarray:
    return np.linspace(0, n_channels - 1, carriers).astype(np.int64)


def make_scene(cfg: dict, traffic: dict, seed: int, device) -> Scene:
    """The cell's segment of air on ``device``, from ``seed``."""
    device = torch.device(device)
    fs = int(cfg["sample_rate"])
    W, hop = cfg["wave_rate"] // 8, int(round(fs / cfg["wave_rate"]))
    n = int(traffic["segment_blocks"]) * W * hop
    C = cfg["channels"]["count"]
    hot = hot_channels(C, int(traffic["carriers"]))
    freqs = channel_frequencies(cfg)

    rng = np.random.default_rng(seed)
    tone_order = rng.permutation(len(hot))
    phases = rng.uniform(0.0, 2.0 * np.pi, size=(len(hot), 3))
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2**63))

    sigma = float(traffic["noise_sigma"]) / math.sqrt(2.0)
    z = torch.randn((n, 2), generator=g, device=device, dtype=torch.float32) * sigma
    idx = torch.arange(n, device=device, dtype=torch.int64)
    on = (idx >= int(n * float(traffic["key_on"]))).to(torch.float32)

    def cycles(freq_hz: int, phase: float) -> torch.Tensor:
        """2 pi (freq n / fs) + phase, the fractional cycle taken exactly."""
        frac = ((idx * int(freq_hz)) % fs).to(torch.float32) * (1.0 / fs)
        return frac * (2.0 * math.pi) + phase

    ampl = min(0.4, 0.5 / math.sqrt(max(1, len(hot))))
    for k, ch in enumerate(hot):
        spec = channel_spec(cfg, int(ch))
        offset = int(freqs[ch] - cfg["center_freq"])
        tone = int(traffic["tone_hz"] + traffic["tone_step_hz"] * int(tone_order[k]))
        ph = cycles(offset, float(phases[k, 0]))
        if spec.modulation == "am":
            env = 1.0 + float(traffic["am_depth"]) * torch.sin(cycles(tone, float(phases[k, 1])))
            amp = ampl * env * on
        else:
            dev = float(traffic["fm_deviation_hz"])
            # FM phase: 2 pi dev * integral of a sin(2 pi f t) = -dev a / f cos(2 pi f t)
            ph = ph - dev * float(traffic["fm_tone_amplitude"]) / tone * torch.cos(cycles(tone, float(phases[k, 1])))
            if spec.ctcss > 0:
                ct = int(round(spec.ctcss))
                ph = ph - dev * float(traffic["ctcss_amplitude"]) / ct * torch.cos(cycles(ct, float(phases[k, 2])))
            amp = ampl * on
        z[:, 0] += amp * torch.cos(ph)
        z[:, 1] += amp * torch.sin(ph)
    return Scene(cfg, quantise(z, cfg), hot)


def quantise(z: torch.Tensor, cfg: dict) -> torch.Tensor:
    """[n, 2] float32 IQ of full scale 1 -> the stream's bytes in the
    configuration's sample format, a flat uint8 tensor (little-endian, as
    the host and the card hold it)."""
    fmt = cfg.get("sample_format", "u8")
    if fmt == "u8":
        return torch.clamp(torch.round(z * 127.5 + 127.5), 0, 255).to(torch.uint8).reshape(-1)
    if fmt == "s8":
        q = torch.clamp(torch.round(z * 128.0), -128, 127).to(torch.int8)
    else:
        scale = float(cfg.get("fullscale") or DEFAULT_FULLSCALE[fmt])
        q = z * scale if fmt == "f32" else torch.clamp(torch.round(z * scale), -32768, 32767).to(torch.int16)
    return q.reshape(-1).view(torch.uint8)
