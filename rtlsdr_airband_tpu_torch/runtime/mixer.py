"""Mixer: N demodulated inputs -> one (possibly stereo) mixed audio channel.

Semantic model of the reference mixer (reference: src/mixer.cpp) redesigned
for the block-synchronous device pipeline: instead of a free-running thread at
2x batch cadence, ``Mixer.poll()`` is called frequently by the app loop and
emits a mixed [W] (or [W, 2] stereo) batch as soon as every live input has
delivered — or when the late-input deadline expires (missing inputs
contribute silence).

The deadline is measured in WALL TIME, like the reference's timer-driven
mixer_thread: the reference loop wakes every WAVE_BATCH/WAVE_RATE/MIX_DIVISOR
= 62.5 ms and tolerates up to MIX_DIVISOR late intervals before force-
emitting (design comment mixer.cpp:142-156, loop :157-261) — a total
tolerance of one batch period (125 ms) for input jitter.  Here the deadline
clock starts when the first input of a batch arrives, so two devices whose
blocks land a few tens of ms apart in wall time (clock skew, independent
dispatch) are always mixed together; emitting on the all-ready condition
(rather than on a fixed timer tick) additionally keeps faster-than-realtime
streams (file input with speedup) lossless, which the reference's
fixed-cadence thread does not.

Per-input gain staging matches mixer_connect_input (mixer.cpp:81-85):
``ampl = min(1, 1-balance)``, ``ampr = min(1, 1+balance)``; any nonzero
balance switches the mixer to stereo.  Inputs are accumulated into the
output buffer at gather time exactly like the reference's incremental
mix_waveforms (mixer.cpp:133-140, gather loop :190-215).

All mutating entry points (put_samples / poll / disable_input) hold one
mixer lock, so channel dispatch may run on per-device sink worker threads
(multiple_output_threads / multiple_demod_threads) while the app loop polls
— the reference guards the same state with per-input mutexes
(mixer.cpp:114-131, :190-215).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np

MIX_DIVISOR = 2  # reference: rtl_airband.h MIX_DIVISOR
BATCH_SEC = 0.125  # WAVE_BATCH / WAVE_RATE (both scale together; rtl_airband.h:73)


@dataclass
class MixInput:
    ampfactor: float = 1.0
    ampl: float = 1.0
    ampr: float = 1.0
    ready: bool = False
    has_signal: bool = False
    enabled: bool = True  # input_mask in the reference
    overrun_count: int = 0
    wavein: np.ndarray | None = None


@dataclass
class Mixer:
    name: str
    wave_batch: int
    stereo: bool = False
    enabled: bool = False
    inputs: list[MixInput] = field(default_factory=list)
    output_overrun_count: int = 0
    has_signal: bool = False
    # late-input tolerance: MIX_DIVISOR intervals of BATCH_SEC/MIX_DIVISOR,
    # i.e. one full batch period (reference: mixer.cpp:142-156)
    tolerance_sec: float = MIX_DIVISOR * (BATCH_SEC / MIX_DIVISOR)
    clock: Callable[[], float] = time.monotonic
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)
    _todo: list[bool] = field(default_factory=list)
    _out_pending: bool = False  # CH_READY: previous output not yet consumed
    _accum: np.ndarray | None = None  # [W, 2] batch under construction
    _accum_signal: bool = False
    _deadline: float | None = None

    def connect_input(self, ampfactor: float = 1.0, balance: float = 0.0) -> int:
        """reference: mixer_connect_input (mixer.cpp:57-94)."""
        if not -1.0 <= balance <= 1.0:
            raise ValueError(f"mixer {self.name}: balance must be within [-1, 1]")
        inp = MixInput(
            ampfactor=ampfactor,
            ampl=min(1.0, 1.0 - balance),
            ampr=min(1.0, 1.0 + balance),
        )
        if balance != 0.0:
            self.stereo = True
        self.inputs.append(inp)
        self._todo.append(True)
        self.enabled = True
        return len(self.inputs) - 1

    def disable_input(self, idx: int) -> None:
        """reference: mixer_disable_input (mixer.cpp:96-112)."""
        with self._lock:
            self.inputs[idx].enabled = False
            if not any(i.enabled for i in self.inputs):
                self.enabled = False

    def put_samples(self, idx: int, samples: np.ndarray, has_signal: bool) -> None:
        """reference: mixer_put_samples (mixer.cpp:114-131)."""
        with self._lock:
            inp = self.inputs[idx]
            inp.has_signal = has_signal
            if has_signal:
                # copy, not view (reference memcpy's into the input buffer,
                # mixer.cpp:126): the producer may reuse/overwrite its audio
                # buffer before the mixer's poll consumes this batch
                inp.wavein = np.array(samples, np.float32, copy=True)
            if inp.ready:
                inp.overrun_count += 1
            else:
                inp.ready = True

    def output_consumed(self) -> None:
        """The app layer has taken the emitted batch (CH_READY -> CH_DIRTY)."""
        self._out_pending = False

    def _gather_locked(self, now: float) -> None:
        """Accumulate newly-ready live inputs into the batch under
        construction (reference: the inputs_todo gather loop,
        mixer.cpp:190-215)."""
        W = self.wave_batch
        for j, inp in enumerate(self.inputs):
            if not (self._todo[j] and inp.enabled and inp.ready):
                continue
            if self._accum is None:
                self._accum = np.zeros((W, 2), np.float32)
                self._accum_signal = False
                self._deadline = now + self.tolerance_sec
            if inp.has_signal and inp.wavein is not None:
                w = inp.wavein[:W]
                self._accum[: len(w), 0] += w * (inp.ampfactor * inp.ampl)
                if self.stereo:
                    self._accum[: len(w), 1] += w * (inp.ampfactor * inp.ampr)
                self._accum_signal = True
            inp.ready = False
            self._todo[j] = False

    def poll(self, now: float | None = None, force: bool = False) -> np.ndarray | None:
        """Gather ready inputs; emit the mixed batch when every live input
        has delivered or the wall-clock deadline has passed (late inputs
        contribute silence — reference: mixer.cpp:153-156).  ``force``
        ignores the deadline (shutdown drain).

        Returns the mixed batch ([W] mono or [W, 2] stereo) when emitted,
        else None.
        """
        with self._lock:
            if not self.enabled:
                return None
            if now is None:
                now = self.clock()
            self._gather_locked(now)
            if self._accum is None:
                return None  # nothing delivered yet for this batch
            pending = any(t for t, i in zip(self._todo, self.inputs) if i.enabled)
            if pending and not force and now < self._deadline:
                return None

            # emit (missing inputs were never accumulated => silence fill)
            if self._out_pending:
                # previous output never consumed (reference: CH_READY
                # overwrite after the interval countdown, mixer.cpp:181-188)
                self.output_overrun_count += 1
            out = self._accum
            self.has_signal = self._accum_signal
            self._accum = None
            self._accum_signal = False
            self._deadline = None
            self._todo = [True] * len(self.inputs)
            self._out_pending = True
            return out[:, 0] if not self.stereo else out
