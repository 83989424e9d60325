"""Per-channel output fan-out + scan-frequency tag queue.

``OutputSet.process`` is the analog of process_outputs (reference:
src/output.cpp:456-559): encode the channel's audio batch once, then fan the
result to every configured sink.  ``TagQueue`` is the 16-slot delayed
metadata queue for scan-mode Icecast "song" tags (reference: util.cpp:47-83,
consumed output.cpp:906-916 with shout_metadata_delay, default 3 s).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from .encoders import AudioEncoder, lame_available, make_encoder
from .filemgr import FileOutput
from .icecast import IcecastOutput
from .pulse import PulseOutput
from .udp import UdpStreamOutput

TAG_QUEUE_LEN = 16  # reference: rtl_airband.h


@dataclass
class _Tag:
    freq_idx: int
    ts: float


class TagQueue:
    """reference: tag_queue_put/get/advance (util.cpp:47-83)."""

    def __init__(self, maxlen: int = TAG_QUEUE_LEN, clock=time.time):
        self._q: list[_Tag] = []
        self.maxlen = maxlen
        self._clock = clock

    def put(self, freq_idx: int) -> None:
        if len(self._q) >= self.maxlen:
            self._q.pop(0)
        self._q.append(_Tag(freq_idx, self._clock()))

    def get(self, delay_sec: float) -> int | None:
        """Head tag's freq_idx if it has aged past the metadata delay."""
        if self._q and self._clock() - self._q[0].ts >= delay_sec:
            return self._q[0].freq_idx
        return None

    def advance(self) -> None:
        if self._q:
            self._q.pop(0)


class OutputSet:
    """All sinks of one channel (or mixer) + the shared encoder."""

    def __init__(self, wave_rate: int, stereo: bool = False, need_mp3: bool = False, highpass: int = 100, lowpass: int = 2500):
        self.wave_rate = wave_rate
        self.stereo = stereo
        self.files: list[FileOutput] = []
        self.iq_files: list[FileOutput] = []
        self.udps: list[UdpStreamOutput] = []
        self.icecasts: list[IcecastOutput] = []
        self.pulses: list[PulseOutput] = []
        self.mixer_feeds: list[tuple[object, int]] = []  # (Mixer, input_idx)
        self.encoder: AudioEncoder | None = None
        if need_mp3:
            kind = "mp3" if lame_available() else "wav"
            self.encoder = make_encoder(kind, wave_rate, stereo, **(dict(highpass=highpass, lowpass=lowpass) if kind == "mp3" else {}))

    @property
    def need_stream_encode(self) -> bool:
        return bool(self.icecasts)

    def process(
        self,
        audio: np.ndarray,  # [W] mono (or left)
        audio_r: np.ndarray | None = None,  # right when stereo
        iq: np.ndarray | None = None,  # [W] complex64 for rawfile sinks
        has_signal: bool = True,
        frequency: int | None = None,
        scan_tag: str | None = None,
    ) -> None:
        """Fan one batch out to every sink (reference: output.cpp:456-559)."""
        encoded = b""
        if self.encoder is not None and self.need_stream_encode:
            encoded = self.encoder.encode(audio, audio_r if self.stereo else None)

        for ice in self.icecasts:
            if ice.connected:
                if scan_tag is not None and ice.send_scan_freq_tags:
                    ice.send_metadata(scan_tag)
                ice.send(encoded)

        for fo in self.files:
            # continuous mode writes silence when closed-squelch; transmission
            # modes only write when there is signal (reference: output.cpp:498-532)
            if has_signal or fo.continuous:
                buf = audio if has_signal else np.zeros_like(audio)
                buf_r = None
                if self.stereo and audio_r is not None:
                    buf_r = audio_r if has_signal else np.zeros_like(audio_r)
                fo.write(buf, frequency, right=buf_r)

        if iq is not None:
            for fo in self.iq_files:
                if has_signal or fo.continuous:
                    fo.write(iq if has_signal else np.zeros_like(iq), frequency)

        for u in self.udps:
            if has_signal:
                u.write(audio, audio_r)

        for p in self.pulses:
            if has_signal:
                p.write(audio, audio_r)

        for mixer, idx in self.mixer_feeds:
            mixer.put_samples(idx, audio, has_signal)

    def check_reconnect(self) -> None:
        """Retry dropped Icecast/Pulse connections (reference:
        output_check_thread, output.cpp:936-1005, 10 s cadence driven by the
        app loop)."""
        for p in self.pulses:
            if hasattr(p, "reconnect"):
                p.reconnect()
        for ice in self.icecasts:
            if not ice.connected:
                ice.connect()

    def close(self) -> None:
        for fo in self.files + self.iq_files:
            fo.close()
        for u in self.udps:
            u.close()
        for ice in self.icecasts:
            ice.disconnect()
        for p in self.pulses:
            p.close()
