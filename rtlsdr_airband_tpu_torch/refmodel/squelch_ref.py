"""Scalar reference squelch state machine (NumPy float32).

Behavioral transcription of the reference 5-state squelch for golden testing
of the vectorized demod (reference: src/squelch.cpp, src/squelch.h,
theory-of-operation comment squelch.h:31-67).  Every recurrence, counter,
delay, cache-invalidation and state-transition rule is reproduced so the
per-sample loop in ops/demod.py can be asserted state-for-state against this model.
"""

from __future__ import annotations

import numpy as np

from .ctcss_ref import CTCSSRef

F32 = np.float32

# State encoding (reference: squelch.h:104-110)
CLOSED = 0
OPENING = 1
CLOSING = 2
LOW_SIGNAL_ABORT = 3
OPEN = 4

STATE_NAMES = {CLOSED: "CLOSED", OPENING: "OPENING", CLOSING: "CLOSING", LOW_SIGNAL_ABORT: "LOW_SIGNAL_ABORT", OPEN: "OPEN"}

MA_DECAY = F32(0.99)
MA_NEW = F32(1.0) - MA_DECAY
NF_DECAY = F32(0.97)
NF_NEW = F32(1.0) - NF_DECAY
NF_BIAS = F32(1e-6)


class SquelchRef:
    """reference: src/squelch.cpp (construction :36-84)."""

    def __init__(self) -> None:
        self.noise_floor = F32(5.0)
        self.manual_signal_level = F32(-1.0)
        self.set_squelch_snr_threshold(9.54)

        self.pre_filter_full = F32(0.001)
        self.pre_filter_capped = F32(0.001)
        self.post_filter_full = F32(0.001)
        self.post_filter_capped = F32(0.001)

        self.squelch_level_cache = F32(0.0)

        self.using_post_filter = False
        self.pre_vs_post_factor = F32(0.9)

        self.open_delay = 197
        self.close_delay = 197
        self.low_signal_abort = 88

        self.next_state = CLOSED
        self.current_state = CLOSED

        self.delay = 0
        self.open_count = 0
        self.sample_count = -1
        self.flappy_count = 0
        self.low_signal_count = 0

        self.recent_sample_size = 1000
        self.flap_opens_threshold = 3
        self.recent_open_count = 0
        self.closed_sample_count = 0

        self.buffer_size = 102
        self.buffer_head = 0
        self.buffer_tail = 1
        self.buffer = np.zeros(self.buffer_size, dtype=F32)

        self.ctcss_fast = CTCSSRef()
        self.ctcss_slow = CTCSSRef()

    # --- configuration -----------------------------------------------------

    def set_squelch_level_threshold(self, level: float) -> None:
        if level > 0:
            self.using_manual_level = True
            self.manual_signal_level = F32(level)
        else:
            self.using_manual_level = False
        self._calculate_moving_avg_cap()

    def set_squelch_snr_threshold(self, db: float) -> None:
        self.using_manual_level = False
        self.normal_signal_ratio = F32(np.power(np.float64(10.0), np.float64(db) / 20.0))
        self.flappy_signal_ratio = self.normal_signal_ratio * F32(0.9)
        self._calculate_moving_avg_cap()

    def set_ctcss_freq(self, ctcss_freq: float, sample_rate: float) -> None:
        self.ctcss_fast = CTCSSRef(ctcss_freq, sample_rate, int(sample_rate * 0.05))
        self.ctcss_slow = CTCSSRef(ctcss_freq, sample_rate, int(sample_rate * 0.4))

    # --- public predicates ---------------------------------------------------

    def is_open(self) -> bool:
        if self.current_state in (OPEN, CLOSING):
            if self.ctcss_slow.is_enabled():
                if self.ctcss_slow.enough_samples:
                    return self.ctcss_slow.get_has_tone()
                return self.ctcss_fast.get_has_tone()
            return True
        return False

    def should_filter_sample(self) -> bool:
        return (self._has_pre_filter_signal() or self.current_state != CLOSED) and self.current_state != LOW_SIGNAL_ABORT

    def should_process_audio(self) -> bool:
        return self.current_state in (OPEN, CLOSING)

    def first_open_sample(self) -> bool:
        return self.current_state != OPEN and self.next_state == OPEN

    def last_open_sample(self) -> bool:
        return (self.current_state == CLOSING and self.next_state == CLOSED) or (self.current_state != LOW_SIGNAL_ABORT and self.next_state == LOW_SIGNAL_ABORT)

    def signal_outside_filter(self) -> bool:
        return self.using_post_filter and self._has_pre_filter_signal() and not self._has_post_filter_signal()

    def noise_level(self) -> np.float32:
        return self.noise_floor

    def signal_level(self) -> np.float32:
        return self.pre_filter_full

    def squelch_level(self) -> np.float32:
        if self.using_manual_level:
            return self.manual_signal_level
        if self.squelch_level_cache == F32(0.0):
            if self._currently_flapping() and self.flappy_signal_ratio < self.normal_signal_ratio:
                self.squelch_level_cache = self.flappy_signal_ratio * self.noise_floor
            else:
                self.squelch_level_cache = self.normal_signal_ratio * self.noise_floor
        return self.squelch_level_cache

    def ctcss_count(self) -> int:
        return self.ctcss_slow.found_count

    def no_ctcss_count(self) -> int:
        return self.ctcss_slow.not_found_count

    # --- sample processing ---------------------------------------------------

    def process_raw_sample(self, sample: float) -> None:
        """reference: src/squelch.cpp:196-246."""
        sample = F32(sample)
        self._update_current_state()
        self.sample_count += 1

        if self.sample_count % 16 == 0:
            self._calculate_noise_floor()

        self._update_moving_avg("pre", sample)

        self.buffer[self.buffer_head] = self.pre_filter_capped * self.pre_vs_post_factor

        if self.current_state == OPEN and not self._has_signal():
            self._set_state(CLOSING)
        if self.current_state == CLOSED and self._has_signal():
            self._set_state(OPENING)

        if self.current_state != CLOSED and self.current_state != LOW_SIGNAL_ABORT:
            if sample >= self.squelch_level():
                self.low_signal_count = 0
            else:
                self.low_signal_count += 1
                if self.low_signal_count >= self.low_signal_abort:
                    self._set_state(LOW_SIGNAL_ABORT)

    def process_filtered_sample(self, sample: float) -> None:
        """reference: src/squelch.cpp:248-276."""
        sample = F32(sample)
        if not self.should_filter_sample():
            return
        if self.current_state == OPENING:
            if self.delay < self.buffer_size:
                return
            if self.delay == self.buffer_size:
                self.post_filter_full = self.buffer[self.buffer_tail]
                self.post_filter_capped = self.buffer[self.buffer_tail]
        self.using_post_filter = True
        self._update_moving_avg("post", sample)
        if self.post_filter_capped < self.buffer[self.buffer_tail]:
            self._set_state(CLOSED)

    def process_audio_sample(self, sample: float) -> None:
        """reference: src/squelch.cpp:278-292."""
        if not self.ctcss_slow.is_enabled():
            return
        if self.current_state != CLOSED:
            self.ctcss_slow.process_audio_sample(sample)
            if not self.ctcss_slow.enough_samples:
                self.ctcss_fast.process_audio_sample(sample)

    # --- internals -----------------------------------------------------------

    def _set_state(self, update: int) -> None:
        """Transition-validity rules. reference: src/squelch.cpp:294-361."""
        cur = self.current_state
        if cur == CLOSED and update == CLOSING:
            update = CLOSED
        elif cur == CLOSED and update == LOW_SIGNAL_ABORT:
            update = CLOSED
        elif cur == CLOSED and update == OPEN:
            update = OPENING
        elif cur == OPENING and update == LOW_SIGNAL_ABORT:
            update = CLOSED
        elif cur == LOW_SIGNAL_ABORT and update != LOW_SIGNAL_ABORT and update != CLOSED:
            update = CLOSED
        elif cur == OPEN and update == CLOSED:
            update = CLOSING
        elif cur == OPEN and update == OPENING:
            update = OPEN
        self.next_state = update

    def _update_current_state(self) -> None:
        """Per-sample state advance. reference: src/squelch.cpp:363-460."""
        if self.next_state == OPENING:
            if self.current_state != OPENING:
                self.delay = 0
                self.low_signal_count = 0
                self.using_post_filter = False
                self.current_state = self.next_state
            else:
                self.delay += 1
                if self.delay >= self.open_delay:
                    if self.closed_sample_count < self.recent_sample_size:
                        self.recent_open_count += 1
                        if self._currently_flapping():
                            self.flappy_count += 1
                        self.squelch_level_cache = F32(0.0)
                    if self._has_signal():
                        self.next_state = OPEN
                    else:
                        self.next_state = CLOSED
        elif self.next_state == CLOSING:
            if self.current_state != CLOSING:
                self.delay = 0
                self.current_state = self.next_state
            else:
                self.delay += 1
                if self.delay >= self.close_delay:
                    if not self._has_signal():
                        self.next_state = CLOSED
                    else:
                        self.current_state = OPEN  # avoid open_count increment
                        self.next_state = OPEN
        elif self.next_state == LOW_SIGNAL_ABORT:
            if self.current_state != LOW_SIGNAL_ABORT:
                if self.current_state != CLOSING:
                    self.delay = 0
                self.current_state = self.next_state
            else:
                self.delay += 1
                if self.delay >= self.close_delay:
                    self.next_state = CLOSED
        elif self.next_state == OPEN and self.current_state != OPEN:
            self.open_count += 1
            self.current_state = self.next_state
        elif self.next_state == CLOSED and self.current_state != CLOSED:
            self.using_post_filter = False
            self.closed_sample_count = 0
            self.current_state = self.next_state
            self.ctcss_fast.reset()
            self.ctcss_slow.reset()
        elif self.next_state == CLOSED and self.current_state == CLOSED:
            if self.closed_sample_count < self.recent_sample_size:
                self.closed_sample_count += 1
            elif self.closed_sample_count == self.recent_sample_size:
                self.recent_open_count = 0
                self.squelch_level_cache = F32(0.0)
        else:
            self.current_state = self.next_state

        self.buffer_tail = (self.buffer_tail + 1) % self.buffer_size
        self.buffer_head = (self.buffer_head + 1) % self.buffer_size

    def _has_pre_filter_signal(self) -> bool:
        return bool(self.pre_filter_capped >= self.squelch_level())

    def _has_post_filter_signal(self) -> bool:
        return self.using_post_filter and bool(self.post_filter_capped >= self.buffer[self.buffer_tail])

    def _has_signal(self) -> bool:
        if self.using_post_filter:
            return self._has_pre_filter_signal() and self._has_post_filter_signal()
        return self._has_pre_filter_signal()

    def _calculate_noise_floor(self) -> None:
        self.noise_floor = self.noise_floor * NF_DECAY + min(self.pre_filter_capped, self.noise_floor) * NF_NEW + NF_BIAS
        self._calculate_moving_avg_cap()
        self.squelch_level_cache = F32(0.0)

    def _calculate_moving_avg_cap(self) -> None:
        if self.using_manual_level:
            self.moving_avg_cap = F32(1.5) * self.manual_signal_level
        else:
            self.moving_avg_cap = F32(1.5) * self.normal_signal_ratio * self.noise_floor

    def _update_moving_avg(self, which: str, sample: np.float32) -> None:
        full = self.pre_filter_full if which == "pre" else self.post_filter_full
        capped = self.pre_filter_capped if which == "pre" else self.post_filter_capped
        full = full * MA_DECAY + sample * MA_NEW
        if capped >= self.moving_avg_cap and sample >= self.moving_avg_cap:
            capped = self.moving_avg_cap
        else:
            capped = min(self.moving_avg_cap, capped * MA_DECAY + sample * MA_NEW)
        if which == "pre":
            self.pre_filter_full, self.pre_filter_capped = full, capped
        else:
            self.post_filter_full, self.post_filter_capped = full, capped

    def _currently_flapping(self) -> bool:
        return self.recent_open_count >= self.flap_opens_threshold
