"""Host-side control plane: scan-mode frequency hopping + AFC bin tracking.

Both are data-dependent cross-block feedback loops, so they stay on the host
between device blocks (SURVEY.md §7 "hard parts"): the device program
returns per-channel activity and (when AFC is on) the last frame's spectrum
power; these controllers inspect them at block cadence and mutate the bins /
center frequency that parameterize the next block.

 - ``ScanController`` reimplements controller_thread (reference:
   src/rtl_airband.cpp:101-139): ~200 ms checks, hop to the next entry of
   ``freqs[]`` after 10 consecutive no-signal checks (2 s), retuning the
   center +20 FFT-bin-widths above the target to dodge the DC spike, and
   queueing a metadata tag on activity.
 - ``AFCTracker`` reimplements class AFC (reference: rtl_airband.cpp:180-251):
   on squelch open, hill-climb adjacent FFT bins while power increases with a
   1/afc threshold growing 10% per step; revert to the base bin on close.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..outputs.dispatch import TagQueue

SCAN_CHECK_PERIOD_SEC = 0.2  # reference: rtl_airband.cpp:111 (SLEEP(200))
SCAN_HOPS_AFTER = 10  # consecutive NO_SIGNAL checks before hop (:115)
SCAN_DC_OFFSET_BINS = 20  # retune +20 bin widths above target (:119-121)


@dataclass
class ScanChannelState:
    freqs: list[int]
    labels: list[str | None]
    freq_idx: int = 0
    no_signal_checks: int = 0
    prev_open: bool = False


class ScanController:
    """One per scan-mode device.  ``tick`` is called by the app loop at
    block cadence with the device's channel-0 activity flag; returns the new
    center frequency when a hop occurs, else None."""

    def __init__(self, freqs: list[int], labels: list[str | None] | None, sample_rate: int, fft_size: int, clock=None, log_scan_activity: bool = False, logger=None):
        import time

        self.st = ScanChannelState(freqs=list(freqs), labels=list(labels) if labels else [None] * len(freqs))
        self.sample_rate = sample_rate
        self.fft_size = fft_size
        self.tag_queue = TagQueue(clock=clock or time.time)
        self._clock = clock or time.time
        self._last_check = 0.0
        self.log_scan_activity = log_scan_activity
        self.logger = logger
        self.tuned_freq_idx_logged: int | None = None

    @property
    def bin_width(self) -> float:
        return self.sample_rate / self.fft_size

    def current_freq(self) -> int:
        return self.st.freqs[self.st.freq_idx]

    def center_for(self, freq: int) -> int:
        """reference: rtl_airband.cpp:119-121 and config.cpp:427-429 —
        center is placed 20 bin-widths above the channel frequency."""
        return int(freq + SCAN_DC_OFFSET_BINS * self.bin_width)

    def tick(self, channel_open: bool) -> int | None:
        now = self._clock()
        if now - self._last_check < SCAN_CHECK_PERIOD_SEC:
            return None
        self._last_check = now
        st = self.st
        if not channel_open:
            st.no_signal_checks += 1
            st.prev_open = False
            if st.no_signal_checks >= SCAN_HOPS_AFTER and len(st.freqs) > 1:
                st.no_signal_checks = 0
                st.freq_idx = (st.freq_idx + 1) % len(st.freqs)
                return self.center_for(st.freqs[st.freq_idx])
            return None
        # activity (reference: :124-136)
        st.no_signal_checks = 0
        if not st.prev_open:
            st.prev_open = True
            if self.log_scan_activity and self.logger:
                label = st.labels[st.freq_idx] or ""
                self.logger(f"Activity on {st.freqs[st.freq_idx] / 1e6:.4f} MHz {label}")
            if self.tuned_freq_idx_logged != st.freq_idx:
                self.tag_queue.put(st.freq_idx)
                self.tuned_freq_idx_logged = st.freq_idx
        return None


@dataclass
class AFCTracker:
    """Per-channel AFC over host-visible spectrum power (one [fft_size]
    power vector per block, from the device program's last frame)."""

    base_bin: int
    afc: int  # 0 = disabled; higher = less sensitive (threshold divisor)
    fft_size: int
    current_bin: int = field(default=-1)
    prev_open: bool = False
    indicator: str = " "  # ' '|'*'|'<'|'>' like the reference status glyphs

    def __post_init__(self):
        if self.current_bin < 0:
            self.current_bin = self.base_bin

    def _climb(self, power: np.ndarray, step: int) -> int:
        """reference: AFC::check (rtl_airband.cpp:194-218)."""
        base = self.base_bin
        base_value = float(power[base])
        threshold = 0.0
        bin_ = base
        while True:
            nxt = bin_ + step
            if nxt < 0 or nxt >= self.fft_size:
                break
            value = float(power[nxt])
            if value <= base_value:
                break
            if bin_ == base:
                threshold = (value - base_value) / float(self.afc)
            else:
                if (value - base_value) < threshold:
                    break
                threshold += threshold / 10.0
            bin_ = nxt
        return bin_

    def finalize(self, is_open: bool, power: np.ndarray | None) -> int:
        """Advance one block; returns the bin to use for the next block
        (reference: AFC::finalize, rtl_airband.cpp:224-250)."""
        if self.afc == 0:
            self.prev_open = is_open
            self.indicator = "*" if is_open else " "
            return self.current_bin
        if is_open and not self.prev_open and power is not None:
            bin_ = self._climb(power, -1)
            if bin_ == self.base_bin:
                bin_ = self._climb(power, +1)
            if bin_ != self.current_bin:
                self.current_bin = bin_
                self.indicator = ">" if bin_ > self.base_bin else ("<" if bin_ < self.base_bin else "*")
            else:
                self.indicator = "*"
        elif not is_open and self.prev_open:
            self.current_bin = self.base_bin
            self.indicator = " "
        else:
            self.indicator = "*" if is_open else " "
        self.prev_open = is_open
        return self.current_bin
