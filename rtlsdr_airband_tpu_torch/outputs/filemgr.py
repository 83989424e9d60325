"""Timestamped rotating file outputs with the reference's lifecycle semantics.

Models src/output.cpp's file manager:
 - filenames ``basename_YYYYmmdd_HH[MMSS][_freq]<suffix>``
   (reference: output.cpp:416-443);
 - ``.tmp`` rename protocol — the live file is written as ``<path>.tmp`` and
   renamed into place on close (reference: output.cpp:251-253, 331-338);
 - optional ``YYYY/mm/dd`` dated subdirectories (reference:
   helper_functions.cpp:73-86, output.cpp:422-432);
 - modes: continuous, append, split_on_transmission with close after 1 h,
   or idle > 0.5 s with min 1 s duration (reference: output.cpp:347-386);
 - hourly rotation for append/continuous (reference: output.cpp:370-385);
 - append-gap marker tones: 120 ms bursts at 2222/1111/555 Hz descending then
   ascending, with per-second silence fill in continuous mode (reference:
   LameTone + open_file, output.cpp:174-313).
"""

from __future__ import annotations

import os
import struct
import time as _time
from dataclasses import dataclass, field

import numpy as np

from .encoders import AudioEncoder, WavEncoder, make_encoder

MIN_TRANSMISSION_TIME_SEC = 1.0
MAX_TRANSMISSION_TIME_SEC = 3600.0
MAX_TRANSMISSION_IDLE_SEC = 0.5


def make_dated_subdirs(basedir: str, t: _time.struct_time) -> str:
    """reference: helper_functions.cpp:73-86."""
    p = os.path.join(basedir, f"{t.tm_year:04d}", f"{t.tm_mon:02d}", f"{t.tm_mday:02d}")
    os.makedirs(p, exist_ok=True)
    return p


def marker_tone(hz: float, msec: int, wave_rate: int) -> np.ndarray:
    """0.9-amplitude sine burst (reference: LameTone, output.cpp:179-214)."""
    n = msec * wave_rate // 1000
    if hz <= 0:
        return np.zeros(n, np.float32)
    t = np.arange(n, dtype=np.float32) / wave_rate
    return (0.9 * np.sin(2.0 * np.pi * hz * t)).astype(np.float32)


@dataclass
class FileOutput:
    basedir: str
    basename: str
    wave_rate: int
    encoder_kind: str = "auto"  # 'mp3' | 'wav' | 'raw' | 'auto'
    stereo: bool = False
    continuous: bool = False
    append: bool = True
    split_on_transmission: bool = False
    include_freq: bool = False
    dated_subdirectories: bool = False
    use_localtime: bool = False
    is_iq: bool = False  # rawfile: complex64 IQ instead of audio
    highpass: int = 100
    lowpass: int = 2500

    f: object = None
    file_path: str = ""
    file_path_tmp: str = ""
    open_time: float = 0.0
    last_write_time: float = 0.0
    encoder: AudioEncoder | None = None
    _clock: object = field(default=_time.time, repr=False)

    # ------------------------------------------------------------- lifecycle

    def _now_tm(self, ts: float) -> _time.struct_time:
        return _time.localtime(ts) if self.use_localtime else _time.gmtime(ts)

    def _new_encoder(self) -> AudioEncoder | None:
        if self.is_iq:
            return None
        from .encoders import lame_available

        kind = self.encoder_kind
        if kind == "auto":
            kind = "mp3" if lame_available() else "wav"
        kw = dict(highpass=self.highpass, lowpass=self.lowpass) if kind == "mp3" else {}
        return make_encoder(kind, self.wave_rate, self.stereo, **kw)

    def close_if_necessary(self) -> None:
        """reference: output.cpp:347-386."""
        if self.f is None:
            return
        now = self._clock()
        if self.split_on_transmission:
            duration = now - self.open_time
            idle = now - self.last_write_time
            if duration > MAX_TRANSMISSION_TIME_SEC or (duration > MIN_TRANSMISSION_TIME_SEC and idle > MAX_TRANSMISSION_IDLE_SEC):
                self.close()
            return
        if self._now_tm(self.open_time).tm_hour != self._now_tm(now).tm_hour:
            self.close()

    def ready(self, frequency: int | None = None) -> bool:
        """Ensure an open file appropriate for 'now'; rotate if needed
        (reference: output_file_ready, output.cpp:388-453)."""
        self.close_if_necessary()
        if self.f is not None:
            return True

        now = self._clock()
        t = self._now_tm(now)
        stamp = _time.strftime("_%Y%m%d_%H%M%S" if self.split_on_transmission else "_%Y%m%d_%H", t)
        outdir = make_dated_subdirs(self.basedir, t) if self.dated_subdirectories else self.basedir
        os.makedirs(outdir, exist_ok=True)

        name = self.basename + stamp
        if self.include_freq and frequency is not None:
            name += f"_{frequency}"
        self.encoder = self._new_encoder()
        self.file_path = os.path.join(outdir, name + (".cf32" if self.is_iq else self.encoder.suffix))
        self.file_path_tmp = self.file_path + ".tmp"

        # .tmp rename protocol: resume a previous final file if present
        if os.path.exists(self.file_path):
            try:
                os.rename(self.file_path, self.file_path_tmp)
            except OSError:
                pass
        resume = self.append and os.path.exists(self.file_path_tmp) and os.path.getsize(self.file_path_tmp) > 0
        prev_mtime = os.path.getmtime(self.file_path_tmp) if resume else now
        try:
            # "r+b"/"w+b" (not "ab") so WAV size patching can seek on close
            self.f = open(self.file_path_tmp, "r+b" if resume else "w+b")
        except OSError:
            self.f = None
            return False
        self.f.seek(0, os.SEEK_END)
        existing_size = self.f.tell()
        self.open_time = self.last_write_time = now

        if existing_size > 0 and not self.is_iq and self.encoder is not None:
            self._write_append_markers(now, prev_mtime)
        return True

    def _write_append_markers(self, now: float, prev_mtime: float) -> None:
        """Discontinuity tones + continuous-mode silence fill
        (reference: open_file, output.cpp:275-308)."""
        wr = self.wave_rate
        if isinstance(self.encoder, WavEncoder):
            # appending to an existing WAV: header already present
            self.encoder._header_sent = True
        for hz in (2222, 1111, 555):
            self.f.write(self.encoder.encode(marker_tone(hz, 120, wr)))
        if self.continuous and now > prev_mtime:
            delta = min(int(now - prev_mtime), 3600)
            silence = np.zeros(wr, np.float32)
            for _ in range(max(0, delta - 1)):
                self.f.write(self.encoder.encode(silence))
        for hz in (555, 1111, 2222):
            self.f.write(self.encoder.encode(marker_tone(hz, 120, wr)))

    def write(self, samples: np.ndarray, frequency: int | None = None, right: np.ndarray | None = None) -> bool:
        """Write one batch (audio float [-1,1], or complex64 IQ if is_iq)."""
        if not self.ready(frequency):
            return False
        if self.is_iq:
            self.f.write(np.asarray(samples, np.complex64).tobytes())
        else:
            self.f.write(self.encoder.encode(samples, right))
        self.last_write_time = self._clock()
        return True

    def close(self) -> None:
        """Flush encoder, finalize WAV sizes, rename .tmp into place
        (reference: close_file, output.cpp:316-338)."""
        if self.f is None:
            return
        if self.encoder is not None:
            tail = self.encoder.flush()
            if tail:
                self.f.write(tail)
            if isinstance(self.encoder, WavEncoder):
                self._patch_wav_sizes()
            if hasattr(self.encoder, "close"):
                self.encoder.close()
        self.f.close()
        self.f = None
        self.encoder = None
        if os.path.exists(self.file_path_tmp):
            os.replace(self.file_path_tmp, self.file_path)
            # stamp mtime from the pipeline clock so a later append measures
            # the true gap (reference compares st_mtime to now, output.cpp:292)
            t = self.last_write_time or self._clock()
            try:
                os.utime(self.file_path, (t, t))
            except OSError:
                pass
        self.file_path = ""
        self.file_path_tmp = ""

    def _patch_wav_sizes(self) -> None:
        size = self.f.tell()
        if size < 44:
            return
        self.f.seek(4)
        self.f.write(struct.pack("<I", size - 8))
        self.f.seek(40)
        self.f.write(struct.pack("<I", size - 44))
        self.f.seek(0, os.SEEK_END)
