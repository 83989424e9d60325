"""The JAX package's App and the port's on the same libconfig text and u8
file (tests/test_torch_app_*.py).

The JAX App runs first, under ``jax.disable_jit()`` with its channelizer
calls recorded (tests/torch_jax_replay.py::RecordedChannelizer); the port's
App then replays them, each after its own channelizer input was found equal
bit for bit, and demodulates with K1's host build.  Both Apps get the same
frozen clock (mixer deadlines, the stats writer, the output check), and
both write WAV, not MP3, so their file sinks can be compared sample by
sample.
"""

import socket
import wave

import numpy as np

import rtlsdr_airband_tpu.outputs.encoders as jax_encoders
import rtlsdr_airband_tpu_torch.outputs.encoders as port_encoders
from rtlsdr_airband_tpu.app import App as JaxApp
from rtlsdr_airband_tpu.runtime.config import loads_config as jax_loads_config
from rtlsdr_airband_tpu_torch.app import App
from rtlsdr_airband_tpu_torch.runtime.config import loads_config
from torch_jax_replay import RecordedChannelizer
from torch_port_common import ATOL, drive_app

# WAV sinks store s16 truncated from float (outputs/encoders.py::_to_pcm16):
# two floats within ATOL may land up to ATOL * 32767 + 1 < 4 codes apart
WAV_LSB = 4


class FrozenClock:
    """The App's clock, the same instant for both packages."""

    def __init__(self, t: float = 1_000_000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def write_wav_everywhere(monkeypatch) -> None:
    """File sinks of both packages write WAV (MP3 bytes cannot be compared
    within a tolerance)."""
    monkeypatch.setattr(jax_encoders, "_LAME", None)
    monkeypatch.setattr(port_encoders, "_LAME", None)


def parity_apps(monkeypatch, jax_text: str, port_text: str | None = None, *, setup=None, max_wall: float = 90.0,
                calls: list | None = None):
    """Run the JAX App on ``jax_text``, then the port's App (device "cpu") on
    ``port_text`` (default: the same text) replaying its channelizer.
    ``setup(app)`` runs on each App before it starts; ``calls`` receives the
    recorded channelizer calls.  Returns (jax App, port App)."""
    write_wav_everywhere(monkeypatch)
    rec = RecordedChannelizer(monkeypatch)

    def run(app):
        if setup is not None:
            setup(app)
        return drive_app(app, max_wall)

    jax_app = rec.jax_run(lambda: run(JaxApp(jax_loads_config(jax_text), clock=FrozenClock())))
    port_app = run(App(loads_config(port_text or jax_text), clock=FrozenClock(), device="cpu"))
    assert rec.all_replayed(), f"replayed {rec.replayed} of {len(rec.calls)} channelizer calls"
    if calls is not None:
        calls.extend(rec.calls)
    return jax_app, port_app


def read_wav(path) -> np.ndarray:
    with wave.open(str(path), "rb") as w:
        return np.frombuffer(w.readframes(w.getnframes()), "<i2")


def assert_wav_close(want, got, label: str) -> None:
    a, b = read_wav(want), read_wav(got)
    assert a.size == b.size > 0, f"{label}: {a.size} vs {b.size} samples"
    d = np.abs(a.astype(np.int32) - b)
    assert d.max() <= WAV_LSB, f"{label}: {int((d > WAV_LSB).sum())} samples more than {WAV_LSB} codes apart"


def assert_f32_close(want: np.ndarray, got: np.ndarray, label: str) -> None:
    assert want.size == got.size > 0, f"{label}: {want.size} vs {got.size} samples"
    d = np.abs(want.astype(np.float64) - got)
    assert d.max() <= ATOL, f"{label}: maxdiff {d.max():.3e}"


def blocks_of(app) -> list:
    """blocks_processed of every device."""
    return [rt.pipeline.blocks_processed for rt in app.devices]


def read_stats(path) -> dict:
    """A stats file as {metric line key: value}, the timing-dependent ring
    overflow count left out (tests/test_app.py::test_fast_path_matches_slow_path)."""
    out = {}
    for line in open(path).read().splitlines():
        if line.startswith("#") or not line.strip() or line.startswith("buffer_overflow_count{"):
            continue
        key, value = line.split("\t")
        out[key] = float(value)
    return out


def assert_stats_close(want_path, got_path, label: str) -> None:
    """Counters equal; the raw levels within ATOL, their dBFS within 1e-3 dB."""
    a, b = read_stats(want_path), read_stats(got_path)
    assert a.keys() == b.keys(), f"{label}: {sorted(a.keys() ^ b.keys())}"
    for k in a:
        bar = 1e-3 if "dbfs" in k else ATOL if "level" in k else 0.0
        assert abs(a[k] - b[k]) <= bar, f"{label}: {k} {a[k]} vs {b[k]}"


class DeviceReplay:
    """Replays several one-device recordings (``parity_apps(calls=...)``) to
    an App that runs those devices together, from any thread: each call is
    matched to the device whose next recorded input it equals bit for bit
    (the devices read different files)."""

    def __init__(self, monkeypatch, recordings: list):
        import threading

        import rtlsdr_airband_tpu_torch.runtime.pipeline as port_pipeline

        self.queues = [list(r) for r in recordings]
        self._lock = threading.Lock()
        for name in ("channelize_matmul", "channelize_fft"):
            monkeypatch.setattr(port_pipeline, name, self._replay)

    def _replay(self, x, bins, window, **kw):
        import torch

        x = x.cpu().numpy()
        with self._lock:
            for q in self.queues:
                if q and q[0][0].shape == x.shape and np.array_equal(q[0][0], x):
                    _, want_bins, mags, iq = q.pop(0)
                    break
            else:
                raise AssertionError("channelizer input matches no device's next recorded call")
        np.testing.assert_array_equal(bins.cpu().numpy(), want_bins)
        return torch.from_numpy(mags.copy()), torch.from_numpy(iq.copy())

    def all_replayed(self) -> bool:
        return not any(self.queues)


def udp_receiver() -> socket.socket:
    """A UDP socket on a free local port with a 4 MiB receive buffer."""
    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4 << 20)
    rx.bind(("127.0.0.1", 0))
    rx.settimeout(0.2)
    return rx


def udp_received(rx: socket.socket) -> np.ndarray:
    """Everything ``rx`` holds, as float32 audio (the udp_stream payload);
    closes it."""
    chunks = []
    try:
        while True:
            chunks.append(rx.recvfrom(65536)[0])
    except socket.timeout:
        pass
    rx.close()
    return np.frombuffer(b"".join(chunks), np.float32)
