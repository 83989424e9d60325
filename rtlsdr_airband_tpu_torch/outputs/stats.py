"""Prometheus-text stats file writer (reference: src/output.cpp:598-869).

Emits the reference's 12 metric families every STATS_INTERVAL seconds:
per-frequency gauges channel_noise_level / channel_dbfs_noise_level /
channel_signal_level / channel_dbfs_signal_level / channel_squelch_level,
per-frequency counters channel_squelch_counter / channel_flappy_counter /
channel_ctcss_counter / channel_no_ctcss_counter / channel_activity_counter,
and per-device/mixer counters buffer_overflow_count / output_overrun_count /
input_overrun_count.  Written atomically via tmp+rename.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field

from ..ops.levels import level_to_dbfs

STATS_INTERVAL = 15.0  # reference: output.cpp:928-930


@dataclass
class FreqStats:
    frequency: int
    label: str | None = None
    noise_level: float = 0.0
    signal_level: float = 0.0
    squelch_level: float = 0.0
    squelch_open_count: int = 0
    flappy_count: int = 0
    ctcss_count: int = 0
    no_ctcss_count: int = 0
    activity_count: int = 0


@dataclass
class DeviceStats:
    index: int
    buffer_overflow_count: int = 0
    output_overrun_count: int = 0
    # Accelerator-build extension: active-channel gather slot overflows (audio of an
    # open channel dropped for a block because active_fetch_slots was
    # exceeded — runtime/pipeline.py Pipeline.gather_overflow_count)
    gather_overflow_count: int = 0
    freqs: list[FreqStats] = field(default_factory=list)


@dataclass
class MixerStats:
    name: str
    output_overrun_count: int = 0
    input_overrun_counts: list[int] = field(default_factory=list)


def _metric(name: str, freq_hz: int, label: str | None, value) -> str:
    lbl = f',label="{label}"' if label else ""
    v = f"{value:.3f}" if isinstance(value, float) else str(value)
    return f'{name}{{freq="{freq_hz / 1e6:.3f}"{lbl}}}\t{v}\n'


class StatsWriter:
    def __init__(self, filepath: str, fft_size: int, clock=time.time):
        self.filepath = filepath
        self.fft_size = fft_size
        self._clock = clock
        # first write 15 s after startup (reference: output_thread's
        # last_stats_write starts at thread launch, output.cpp:879,928-930)
        self._last_write = clock()

    def due(self) -> bool:
        """True when the next maybe_write() will actually write (lets the
        app defer per-channel stats aggregation to write cadence)."""
        return self._clock() - self._last_write >= STATS_INTERVAL

    def maybe_write(self, devices: list[DeviceStats], mixers: list[MixerStats] | None = None) -> bool:
        now = self._clock()
        if now - self._last_write < STATS_INTERVAL:
            return False
        self.write(devices, mixers)
        self._last_write = now
        return True

    def write(self, devices: list[DeviceStats], mixers: list[MixerStats] | None = None) -> None:
        mixers = mixers or []
        parts: list[str] = []

        def family(name: str, kind: str, help_: str, rows: list[str]) -> None:
            parts.append(f"# HELP {name} {help_}\n# TYPE {name} {kind}\n")
            parts.extend(rows)
            parts.append("\n")

        def per_freq(value_fn):
            return [_metric(name, f.frequency, f.label, value_fn(f)) for d in devices for f in d.freqs]

        name = "channel_noise_level"
        family(name, "gauge", "Raw squelch noise_level.", per_freq(lambda f: float(f.noise_level)))
        name = "channel_dbfs_noise_level"
        family(name, "gauge", "Squelch noise_level as dBFS.", per_freq(lambda f: float(level_to_dbfs(max(f.noise_level, 1e-30), self.fft_size))))
        name = "channel_signal_level"
        family(name, "gauge", "Raw squelch signal_level.", per_freq(lambda f: float(f.signal_level)))
        name = "channel_dbfs_signal_level"
        family(name, "gauge", "Squelch signal_level as dBFS.", per_freq(lambda f: float(level_to_dbfs(max(f.signal_level, 1e-30), self.fft_size))))
        name = "channel_squelch_level"
        family(name, "gauge", "Squelch squelch_level.", per_freq(lambda f: float(f.squelch_level)))
        name = "channel_squelch_counter"
        family(name, "counter", "Squelch open_count.", per_freq(lambda f: f.squelch_open_count))
        name = "channel_flappy_counter"
        family(name, "counter", "Squelch flappy_count.", per_freq(lambda f: f.flappy_count))
        name = "channel_ctcss_counter"
        family(name, "counter", "count of windows with CTCSS detected.", per_freq(lambda f: f.ctcss_count))
        name = "channel_no_ctcss_counter"
        family(name, "counter", "count of windows without CTCSS detected.", per_freq(lambda f: f.no_ctcss_count))
        name = "channel_activity_counter"
        family(name, "counter", "Loops of output_thread with frequency active.", per_freq(lambda f: f.activity_count))

        family(
            "buffer_overflow_count", "counter", "Number of times a device's buffer has overflowed.",
            [f'buffer_overflow_count{{device="{d.index}"}}\t{d.buffer_overflow_count}\n' for d in devices],
        )
        family(
            "output_overrun_count", "counter", "Number of times a device or mixer output has overrun.",
            [f'output_overrun_count{{device="{d.index}"}}\t{d.output_overrun_count}\n' for d in devices]
            + [f'output_overrun_count{{mixer="{m.name}"}}\t{m.output_overrun_count}\n' for m in mixers],
        )
        family(
            "input_overrun_count", "counter", "Number of times mixer input has overrun.",
            [f'input_overrun_count{{mixer="{m.name}",input="{i}"}}\t{c}\n' for m in mixers for i, c in enumerate(m.input_overrun_counts)],
        )
        family(
            "gather_overflow_count", "counter", "Open-channel audio blocks dropped because active_fetch_slots was exceeded.",
            [f'gather_overflow_count{{device="{d.index}"}}\t{d.gather_overflow_count}\n' for d in devices],
        )

        tmp = self.filepath + ".tmp"
        os.makedirs(os.path.dirname(self.filepath) or ".", exist_ok=True)
        with open(tmp, "w") as f:
            f.write("".join(parts))
        os.replace(tmp, self.filepath)
