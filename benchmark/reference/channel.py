"""The reference's block: sample decode, channelizer, demod and the sinks' wire format.

Plain NumPy and PyTorch on the CPU, for a sample of channels.  Everything the
program derives in its set-up (channel specs, bins, taps, parameters, the
priming state) is worked out here again from the configuration file and the
raw bytes in its ``sample_format``.  The channelizer is the windowed DFT at
each channel's bin, computed in float64 and rounded once to float32; the
demod is the frozen plain version in ``demod.py``.

``precision="tf32"`` is the control: the channelizer's inputs rounded to
TF32 (a 10-bit mantissa, as the tensor cores read float32 operands when
``allow_tf32`` is on), products summed in float64.
"""

from __future__ import annotations

import numpy as np
import torch

from .constants import AGC_EXTRA
from .demod import DemodState, demod_block
from .params import ChannelSpec, init_demod_state, make_channel_params
from .window import blackman_harris_7


def bin_for_freq(freq: int, center_freq: int, sample_rate: int, fft_size: int) -> int:
    """FFT bin of a channel, with the upstream integer-divide bin width
    (config.cpp:661-664)."""
    bin_width = sample_rate // fft_size
    return int(np.ceil((freq + sample_rate - center_freq) / float(bin_width) - 1.0)) % fft_size


def channel_frequencies(cfg: dict) -> np.ndarray:
    """Every channel's frequency in user order: spread evenly over
    ``span_fraction`` of the band around the centre."""
    ch = cfg["channels"]
    n, center = ch["count"], cfg["center_freq"]
    span = int(cfg["sample_rate"] * ch["span_fraction"])
    return np.array([center - span // 2 + (i + 1) * span // (n + 1) for i in range(n)], np.int64)


def channel_spec(cfg: dict, i: int) -> ChannelSpec:
    """User channel ``i`` as the configuration states it: kind ``i % len(kinds)``,
    a manual squelch where the file gives one, CTCSS on the listed channels."""
    ch = cfg["channels"]
    kind = dict(ch["kinds"][i % len(ch["kinds"])])
    if i in ch.get("ctcss_channels", ()):
        kind["ctcss"] = ch["ctcss_tone_hz"]
    if "squelch_threshold_dbfs" in ch:
        kind["squelch_threshold_dbfs"] = ch["squelch_threshold_dbfs"]
    return ChannelSpec(frequency=int(channel_frequencies(cfg)[i]), **kind)


# Bytes of one complex sample (I and Q) in each upstream sample format, and the
# default full scale of the formats that take one (rtl_airband.cpp:316-324,
# 402-455): u8 (CU8) is (v - 127.5) / 127.5 and s8 (CS8) v / 128 whatever the
# full scale; s16 (CS16) and f32 (CF32) are v / fullscale.
BYTES_PER_SAMPLE = {"u8": 2, "s8": 2, "s16": 4, "f32": 8}
DEFAULT_FULLSCALE = {"s16": 32768.0, "f32": 1.0}


def decode_u8(raw: np.ndarray) -> np.ndarray:
    """Interleaved u8 IQ -> [L, 2] float32, (v - 127.5) / 127.5 rounded once."""
    v = (raw.astype(np.float64) - 127.5) / 127.5
    return v.astype(np.float32).reshape(-1, 2)


def decode(raw: np.ndarray, sample_format: str, fullscale: float | None = None) -> np.ndarray:
    """Interleaved IQ in ``sample_format``, as raw little-endian bytes ->
    [L, 2] float32: the level in float64, rounded once."""
    raw = np.ascontiguousarray(raw, np.uint8)
    if sample_format == "u8":
        return decode_u8(raw)
    if sample_format == "s8":
        v = raw.view(np.int8).astype(np.float64) / 128.0
    elif sample_format in DEFAULT_FULLSCALE:
        dtype = "<i2" if sample_format == "s16" else "<f4"
        scale = DEFAULT_FULLSCALE[sample_format] if fullscale is None else float(fullscale)
        v = raw.view(dtype).astype(np.float64) / scale
    else:
        raise ValueError(f"unknown sample format {sample_format!r}")
    return v.astype(np.float32).reshape(-1, 2)


def _tf32(a: np.ndarray) -> np.ndarray:
    """float32 values rounded to nearest-even at a 10-bit mantissa."""
    b = np.ascontiguousarray(a, np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0xFFF + ((b >> 13) & 1)) & ~np.uint64(0x1FFF)
    return b.astype(np.uint32).view(np.float32)


def channelize(x: np.ndarray, bins: np.ndarray, *, hop: int, fft_size: int, n_frames: int, precision: str = "f64"):
    """Windowed DFT of ``n_frames`` frames at ``bins``: (mags [F, S], iq [F, S, 2]) float32."""
    n = np.arange(fft_size)
    w = blackman_harris_7(fft_size).astype(np.float64)
    ang = -2.0 * np.pi * ((bins[:, None].astype(np.int64) * n[None, :]) % fft_size) / fft_size
    tr, ti = np.cos(ang) * w, np.sin(ang) * w  # [S, N]
    idx = np.arange(n_frames)[:, None] * hop + n[None, :]
    fr, fi = x[idx, 0].astype(np.float64), x[idx, 1].astype(np.float64)  # [F, N]
    if precision == "tf32":
        fr, fi = (_tf32(a).astype(np.float64) for a in (fr, fi))
        tr, ti = (_tf32(a.astype(np.float32)).astype(np.float64) for a in (tr, ti))
    elif precision != "f64":
        raise ValueError(f"unknown precision {precision!r}")
    yr = fr @ tr.T - fi @ ti.T
    yi = fr @ ti.T + fi @ tr.T
    mags = np.sqrt(yr * yr + yi * yi).astype(np.float32)
    return mags, np.stack([yr, yi], axis=-1).astype(np.float32)


class Reference:
    """The configuration's channels ``users`` (user indices), worked out from
    the file: specs, bins, parameters."""

    def __init__(self, cfg: dict, users):
        self.cfg = cfg
        self.users = np.asarray(users, np.int64)
        self.specs = [channel_spec(cfg, int(i)) for i in self.users]
        self.sample_rate, self.fft_size = cfg["sample_rate"], cfg["fft_size"]
        self.hop = int(round(cfg["sample_rate"] / cfg["wave_rate"]))
        self.W = cfg["wave_rate"] // 8
        self.bins = np.array([bin_for_freq(s.frequency, cfg["center_freq"], self.sample_rate, self.fft_size) for s in self.specs], np.int64)
        self.params = make_channel_params(self.specs, wave_rate=cfg["wave_rate"], sample_rate=self.sample_rate,
                                          center_freq=cfg["center_freq"], fft_size=self.fft_size, device="cpu")
        self.with_ctcss = any(s.ctcss > 0 for s in self.specs)
        self.sample_format, self.fullscale = cfg.get("sample_format", "u8"), cfg.get("fullscale")
        self.bps = BYTES_PER_SAMPLE[self.sample_format]

    @property
    def prime_bytes(self) -> int:
        return self.bps * ((AGC_EXTRA - 1) * self.hop + self.fft_size)

    @property
    def block_bytes(self) -> int:
        return self.bps * ((self.W - 1) * self.hop + self.fft_size)

    def prime(self, raw: np.ndarray, precision: str = "f64") -> DemodState:
        """The initial state from the stream's first AGC_EXTRA frames."""
        x = decode(raw[: self.prime_bytes], self.sample_format, self.fullscale)
        mags, iqs = channelize(x, self.bins, hop=self.hop, fft_size=self.fft_size, n_frames=AGC_EXTRA, precision=precision)
        return init_demod_state(len(self.users), torch.from_numpy(mags), torch.from_numpy(iqs))

    def block(self, raw: np.ndarray, state: DemodState, precision: str = "f64"):
        """One block from its raw bytes and the state it starts from:
        (state', audio [W, S], open_flags [W, S], snapshots of state')."""
        x = decode(raw[: self.block_bytes], self.sample_format, self.fullscale)
        mags, iqs = channelize(x, self.bins, hop=self.hop, fft_size=self.fft_size, n_frames=self.W, precision=precision)
        st, audio, _, flags = demod_block(self.params, state, torch.from_numpy(mags), torch.from_numpy(iqs),
                                          with_ctcss=self.with_ctcss)
        return st, audio.numpy(), flags.numpy(), snapshots(self.params, st)


def snapshots(p, st: DemodState) -> dict:
    """The per-channel values the block program reports about its state
    (signal, noise and squelch levels; the outside-filter flag; counters)."""
    flapping = st.recent_open_count >= 3
    ratio = torch.where(flapping & (p.flappy_ratio < p.normal_ratio), p.flappy_ratio, p.normal_ratio)
    squelch_level = torch.where(p.using_manual, p.manual_level, ratio * st.noise_floor)
    sig_outside = st.using_post_filter & (st.pre_capped >= squelch_level) & (st.post_capped < st.sq_buffer[0])
    out = dict(signal_level=st.pre_full, noise_level=st.noise_floor, squelch_level=squelch_level, sig_outside=sig_outside,
               open_count=st.open_count, flappy_count=st.flappy_count, ctcss_found=st.slow.found,
               ctcss_not_found=st.slow.not_found)
    return {k: v.numpy() for k, v in out.items()}


def i8bf(audio: np.ndarray) -> np.ndarray:
    """What a sink receives of a [W, S] block under block-float int8 audio:
    one scale a column (its peak), mantissas rounded half to even, and the
    float32 product of mantissa and scale / 127."""
    a = np.asarray(audio, np.float32)
    scale = np.max(np.abs(a), axis=0)
    with np.errstate(divide="ignore"):
        inv = np.where(scale > 0, np.float32(127.0) / scale, np.float32(0.0)).astype(np.float32)
    codes = np.round(a * inv[None, :]).astype(np.int8)
    return codes.astype(np.float32) * (scale * np.float32(1.0 / 127.0))[None, :]
