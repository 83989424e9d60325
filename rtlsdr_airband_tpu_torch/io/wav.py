"""Streaming WAV (PCM s16) writer with append support.

The reference emits headerless MP3 streams, which append trivially; WAV needs
its RIFF sizes patched on close, and appending re-opens the file and extends
the data chunk.
"""

from __future__ import annotations

import os
import struct

HDR_LEN = 44


def _header(n_channels: int, sample_rate: int, data_bytes: int) -> bytes:
    byte_rate = sample_rate * n_channels * 2
    return b"RIFF" + struct.pack("<I", 36 + data_bytes) + b"WAVEfmt " + struct.pack(
        "<IHHIIHH", 16, 1, n_channels, sample_rate, byte_rate, n_channels * 2, 16
    ) + b"data" + struct.pack("<I", data_bytes)


class WavWriter:
    def __init__(self, path: str, sample_rate: int, n_channels: int = 1, append: bool = False):
        self.path = path
        self.sample_rate = sample_rate
        self.n_channels = n_channels
        exists = append and os.path.exists(path) and os.path.getsize(path) > HDR_LEN
        if exists:
            self.f = open(path, "r+b")
            self.f.seek(0, os.SEEK_END)
            self._data_bytes = self.f.tell() - HDR_LEN
        else:
            self.f = open(path, "wb")
            self.f.write(_header(n_channels, sample_rate, 0))
            self._data_bytes = 0

    def write_float(self, samples) -> None:
        """samples: float array in [-1, 1]; interleaved if stereo."""
        import numpy as np

        pcm = np.clip(np.asarray(samples, np.float32), -1.0, 1.0)
        pcm = (pcm * 32767.0).astype("<i2")
        b = pcm.tobytes()
        self.f.write(b)
        self._data_bytes += len(b)

    def flush(self) -> None:
        pos = self.f.tell()
        self.f.seek(0)
        self.f.write(_header(self.n_channels, self.sample_rate, self._data_bytes))
        self.f.seek(pos)
        self.f.flush()

    def close(self) -> None:
        if self.f:
            self.flush()
            self.f.close()
            self.f = None
