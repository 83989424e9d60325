"""Scalar reference demodulation pipeline (NumPy, float32).

Behavioral transcription of the reference per-sample demod loop for golden
testing of the demod kernel K1 and its plain PyTorch version (reference: src/rtl_airband.cpp:286-672 — the
``demodulate()`` thread body), including:

 - the sliding-FFT channelizer semantics (one windowed DFT bin per output
   audio sample, hop = round(sample_rate / wave_rate)),
 - the AGC_EXTRA=100-sample look-back structure of wavein/waveout/iq_in,
 - gated derotation with the 24-bit fixed-point phase accumulator,
 - squelch / lowpass / notch / CTCSS / AGC per-sample recurrences,
 - AM and NFM demodulation,
 - the batch emit/carry protocol (memmove of wavein/iq_in by WAVE_BATCH,
   waveout AGC_EXTRA tail copy — reference: rtl_airband.cpp:621-624,
   output.cpp:920).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..constants import AGC_EXTRA
from ..ops.sincos import compute_dm_dphi, make_sincos_tables
from ..ops.window import blackman_harris_7
from .filters_ref import LowpassFilterRef, NotchFilterRef
from .squelch_ref import SquelchRef

F32 = np.float32
M_1_PI = F32(1.0 / np.pi)


def fast_atan2(y: np.float32, x: np.float32) -> np.float32:
    """Polynomial-free atan2 approximation. reference: rtl_airband.cpp:147-166."""
    pi4 = F32(np.pi / 4)
    pi34 = F32(3 * np.pi / 4)
    if x == F32(0.0) and y == F32(0.0):
        return F32(0.0)
    yabs = y if y >= F32(0.0) else -y
    if x >= F32(0.0):
        angle = pi4 - pi4 * (x - yabs) / (x + yabs)
    else:
        angle = pi34 - pi4 * (x + yabs) / (yabs - x)
    return -angle if y < F32(0.0) else angle


def polar_disc_fast(ar, aj, br, bj) -> np.float32:
    """Conj-multiply + fast_atan2. reference: rtl_airband.cpp:168-172."""
    cr = ar * br - aj * (-bj)
    cj = aj * br + ar * (-bj)
    return F32(fast_atan2(cj, cr) * M_1_PI)


def fm_quadri_demod(ar, aj, br, bj) -> np.float32:
    """reference: rtl_airband.cpp:174-176."""
    return F32((br * aj - ar * bj) / (ar * ar + aj * aj + F32(1.0)) * M_1_PI)


def sincosf_lut_ref(phi: int, sin_lut: np.ndarray, cos_lut: np.ndarray) -> tuple[np.float32, np.float32]:
    """Interpolated LUT sincos of 24-bit phase. reference: util.cpp:113-127."""
    idx = (phi >> 16) & 0xFF
    fract = F32(phi & 0xFFFF) / F32(65536.0)
    s = sin_lut[idx] + (sin_lut[idx + 1] - sin_lut[idx]) * fract
    c = cos_lut[idx] + (cos_lut[idx + 1] - cos_lut[idx]) * fract
    return s, c


@dataclass
class ChannelRefConfig:
    modulation: str = "am"  # 'am' | 'nfm'
    frequency: int = 0  # channel RF frequency (Hz), for dm_dphi
    ampfactor: float = 1.0
    bandwidth: float = 0.0  # lowpass filter bandwidth (Hz), 0 = disabled
    notch: float = 0.0  # notch frequency (Hz), 0 = disabled
    notch_q: float = 10.0
    ctcss: float = 0.0  # CTCSS tone (Hz), 0 = disabled
    squelch_threshold_dbfs: float | None = None  # manual squelch level (dBFS)
    squelch_snr_threshold_db: float | None = None
    has_iq_outputs: bool = False
    tau_us: float | None = None  # NFM de-emphasis tau (microseconds)
    fm_demod: str = "atan2"  # 'atan2' | 'quadri'


class ChannelRef:
    """One demodulated channel: squelch + filters + AM/NFM demod state.

    Mirrors channel_t + freq_t state init (reference: config.cpp:270-335).
    """

    def __init__(self, cfg: ChannelRefConfig, wave_rate: int, fft_size: int = 512, sample_rate: int = 2_560_000, center_freq: int = 0):
        self.cfg = cfg
        self.wave_rate = wave_rate
        self.squelch = SquelchRef()
        if cfg.squelch_snr_threshold_db is not None:
            self.squelch.set_squelch_snr_threshold(cfg.squelch_snr_threshold_db)
        if cfg.squelch_threshold_dbfs is not None:
            from ..ops.levels import dbfs_to_level

            self.squelch.set_squelch_level_threshold(dbfs_to_level(cfg.squelch_threshold_dbfs, fft_size))
        if cfg.ctcss > 0:
            self.squelch.set_ctcss_freq(cfg.ctcss, wave_rate)
        self.lowpass = LowpassFilterRef(cfg.bandwidth / 2.0 if cfg.bandwidth > 0 else 0.0, wave_rate)
        self.notch = NotchFilterRef(cfg.notch, wave_rate, cfg.notch_q)
        self.modulation = cfg.modulation
        self.ampfactor = F32(cfg.ampfactor)
        self.needs_raw_iq = cfg.modulation == "nfm" or self.lowpass.enabled or cfg.has_iq_outputs
        self.has_iq_outputs = cfg.has_iq_outputs

        # Derotator (reference: config.cpp:666-712)
        if self.needs_raw_iq:
            self.dm_dphi = compute_dm_dphi(cfg.frequency, center_freq, sample_rate, wave_rate)
        else:
            self.dm_dphi = 0
        self.dm_phi = 0

        # AM AGC / NFM DC+de-emphasis state (reference: config.cpp:274, :327-330)
        self.agcavgfast = F32(0.5)
        self.pr = F32(0.0)
        self.pj = F32(0.0)
        self.prev_waveout = F32(0.5)
        tau = cfg.tau_us if cfg.tau_us is not None else 200.0
        self.alpha = F32(0.0) if tau == 0 else F32(np.exp(-1.0 / (wave_rate * 1e-6 * tau)))
        self.fm_demod = cfg.fm_demod

        # Rolling buffers (reference: rtl_airband.h:232-241, config.cpp:312-316)
        W = wave_rate // 8
        self.W = W
        wave_len = 2 * W + AGC_EXTRA
        self.wavein = np.zeros(wave_len, dtype=F32)
        self.waveout = np.zeros(wave_len, dtype=F32)
        self.iq_in = np.zeros(wave_len, dtype=np.complex64)
        self.iq_out = np.zeros(wave_len, dtype=np.complex64)
        self.wavein[:AGC_EXTRA] = F32(20.0)
        self.waveout[:AGC_EXTRA] = F32(0.5)
        self.axcindicate = False
        self.active_counter = 0


class DeviceRef:
    """Scalar reference device: feeds channelized samples through the
    per-sample loop with the reference's waveend/memmove batch protocol
    (reference: rtl_airband.cpp:463-672)."""

    def __init__(self, channels: list[ChannelRef], wave_rate: int):
        assert channels
        self.channels = channels
        self.wave_rate = wave_rate
        self.W = wave_rate // 8
        self.waveend = 0
        self.sin_lut, self.cos_lut = make_sincos_tables()

    def push(self, mags: np.ndarray, iqs: np.ndarray) -> list[tuple[np.ndarray, np.ndarray]]:
        """Append channelizer outputs (``mags``/``iqs`` shaped [C, n]) and run
        demod batches as they fill.  Returns list of emitted batches, each
        (waveout [C, W], iq_out [C, W] complex64)."""
        C = len(self.channels)
        assert mags.shape[0] == C
        out = []
        n = mags.shape[1]
        pos = 0
        W, A = self.W, AGC_EXTRA
        while pos < n:
            take = min(n - pos, W + A - self.waveend)
            for ci, ch in enumerate(self.channels):
                ch.wavein[self.waveend : self.waveend + take] = mags[ci, pos : pos + take]
                if ch.needs_raw_iq:
                    ch.iq_in[self.waveend : self.waveend + take] = iqs[ci, pos : pos + take]
            self.waveend += take
            pos += take
            if self.waveend >= W + A:
                out.append(self._process_batch())
        return out

    def _process_batch(self) -> tuple[np.ndarray, np.ndarray]:
        W, A = self.W, AGC_EXTRA
        C = len(self.channels)
        waveouts = np.zeros((C, W), dtype=F32)
        iqouts = np.zeros((C, W), dtype=np.complex64)
        for ci, ch in enumerate(self.channels):
            self._demod_channel(ch)
            waveouts[ci] = ch.waveout[:W]
            iqouts[ci] = ch.iq_out[:W]
            # Slide buffers (reference: rtl_airband.cpp:621-624, output.cpp:920)
            ch.wavein[: self.waveend - W] = ch.wavein[W : self.waveend]
            if ch.needs_raw_iq:
                ch.iq_in[: self.waveend - W] = ch.iq_in[W : self.waveend]
            ch.waveout[:A] = ch.waveout[W : W + A]
        self.waveend -= W
        return waveouts, iqouts

    def _demod_channel(self, ch: ChannelRef) -> None:
        """The per-sample loop. reference: rtl_airband.cpp:495-648."""
        W, A = self.W, AGC_EXTRA
        sq = ch.squelch
        ch.axcindicate = False
        for j in range(A, W + A):
            real = ch.iq_in[j - A].real
            imag = ch.iq_in[j - A].imag

            sq.process_raw_sample(ch.wavein[j])

            if sq.should_filter_sample() and ch.needs_raw_iq:
                swf, cwf = sincosf_lut_ref(ch.dm_phi, self.sin_lut, self.cos_lut)
                re_tmp = real * cwf - imag * (-swf)
                im_tmp = imag * cwf + real * (-swf)
                ch.dm_phi = (ch.dm_phi + ch.dm_dphi) & 0xFFFFFF

                re_tmp, im_tmp = ch.lowpass.apply(re_tmp, im_tmp)

                real, imag = F32(re_tmp), F32(im_tmp)
                ch.iq_in[j - A] = np.complex64(complex(real, imag))
                # f32 sqrt (C++ uses double sqrt then narrows; <=1ulp apart,
                # kept f32 here so the demod can match bit-for-bit)
                ch.wavein[j] = np.sqrt(real * real + imag * imag)

                if ch.lowpass.enabled:
                    sq.process_filtered_sample(ch.wavein[j])

            if ch.modulation == "am":
                if sq.first_open_sample():
                    for k in range(j - A, j):
                        if ch.wavein[k] >= sq.squelch_level():
                            ch.agcavgfast = ch.agcavgfast * F32(0.9) + ch.wavein[k] * F32(0.1)
                elif sq.last_open_sample():
                    for k in range(j - A + 1, j):
                        ch.waveout[k] = ch.waveout[k - 1] * F32(0.94)

            waveout = ch.waveout[j]
            if sq.should_process_audio():
                if ch.modulation == "am":
                    if ch.wavein[j] > sq.squelch_level():
                        ch.agcavgfast = ch.agcavgfast * F32(0.995) + ch.wavein[j] * F32(0.005)
                    waveout = (ch.wavein[j - A] - ch.agcavgfast) / (ch.agcavgfast * F32(1.5))
                    if abs(waveout) > F32(0.8):
                        waveout = waveout * F32(0.85)
                        ch.agcavgfast = ch.agcavgfast * F32(1.15)
                else:  # nfm
                    if ch.fm_demod == "atan2":
                        waveout = polar_disc_fast(real, imag, ch.pr, ch.pj)
                    else:
                        waveout = fm_quadri_demod(real, imag, ch.pr, ch.pj)
                    ch.pr = real
                    ch.pj = imag
                    ch.agcavgfast = ch.agcavgfast * F32(0.995) + waveout * F32(0.005)
                    waveout = waveout - ch.agcavgfast
                    waveout = waveout * (F32(1.0) - ch.alpha) + ch.prev_waveout * ch.alpha
                    ch.prev_waveout = waveout

                sq.process_audio_sample(waveout)

            if sq.is_open():
                waveout = ch.notch.apply(waveout)
                waveout = waveout * ch.ampfactor
                if np.isnan(waveout):
                    waveout = F32(0.0)
                elif waveout > F32(1.0):
                    waveout = F32(1.0)
                elif waveout < F32(-1.0):
                    waveout = F32(-1.0)
                ch.axcindicate = True
                if ch.has_iq_outputs:
                    ch.iq_out[j - A] = np.complex64(complex(real, imag))
            else:
                waveout = F32(0.0)
                if ch.has_iq_outputs:
                    ch.iq_out[j - A] = 0
            ch.waveout[j] = waveout

        if ch.axcindicate:
            ch.active_counter += 1


class ChannelizerRef:
    """Scalar sliding-window FFT channelizer (reference: rtl_airband.cpp:394,
    :457-490): one size-N windowed FFT per output audio sample, hop =
    round(sample_rate / wave_rate); per channel take bin magnitude + raw IQ."""

    def __init__(self, fft_size: int, sample_rate: int, wave_rate: int, bins: np.ndarray):
        self.fft_size = fft_size
        self.hop = int(round(sample_rate / wave_rate))
        self.window = blackman_harris_7(fft_size).astype(F32)
        self.bins = np.asarray(bins, dtype=np.int64)
        self._pending = np.zeros(0, dtype=np.complex64)

    def push(self, x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Consume complex64 IQ; return (mags [C, n], iqs [C, n]) for as many
        full frames as available."""
        x = np.concatenate([self._pending, np.asarray(x, dtype=np.complex64)])
        N, hop = self.fft_size, self.hop
        n_frames = max(0, (len(x) - N) // hop + 1)
        C = len(self.bins)
        mags = np.zeros((C, n_frames), dtype=F32)
        iqs = np.zeros((C, n_frames), dtype=np.complex64)
        for g in range(n_frames):
            frame = x[g * hop : g * hop + N] * self.window
            X = np.fft.fft(frame.astype(np.complex64))
            sel = X[self.bins].astype(np.complex64)
            iqs[:, g] = sel
            # plain sqrt(re^2+im^2) in f32 (reference: rtl_airband.cpp:475,
            # sqrtf, not hypot)
            mags[:, g] = np.sqrt(sel.real * sel.real + sel.imag * sel.imag)
        self._pending = x[n_frames * hop :]
        return mags, iqs


def bin_for_freq(freq: int, center_freq: int, sample_rate: int, fft_size: int) -> int:
    """FFT bin assignment, incl. the reference's integer-divide bin width.
    reference: config.cpp:661-664."""
    bin_width = sample_rate // fft_size
    return int(np.ceil((freq + sample_rate - center_freq) / float(bin_width) - 1.0)) % fft_size
