"""Adaptive fetch economy: ride out device->host transport drift.

The production fetch knobs (``active_fetch_slots``, ``fetch_audio_fmt``) are
chosen for a measured transport bandwidth — but a device-to-host transport
can drift between sessions and have slow windows, and a
fixed configuration then either silently sheds audio (slot overflow) or
falls behind realtime with nothing but counters to show for it.  The
reference's operational contract is graceful, *visible* load management
(overrun counters + NOTICE logs, reference: src/rtl_airband.cpp:649-655);
this controller is the accelerator-side equivalent: watch the measured block
handling time and the gather-overflow counter, and move the pipeline
between a small ladder of (active_slots, audio_fmt) programs — logging a
NOTICE on every shift.

The ladder is ordered best-quality-first; in the JAX package each rung is
a distinct jit program, so the app pre-warms the current rung's neighbors in
the background to make shifts cheap (the port's rungs share its kernels:
there ``Pipeline.warm_async`` only builds a kernel library not yet loaded).

Policy (hysteresis + cooldown, all tunable):
 - EMA of measured ms/block > ``high_water`` x budget for ``slow_obs``
   consecutive observations -> step DOWN one rung (cheaper bytes; shedding
   quality beats shedding audio).
 - sustained gather overflow (>= ``overflow_obs`` consecutive observations
   with drops) -> jump to the cheapest rung with MORE slots than the
   current one (more audio kept per block at fewer bytes per channel).
   The landed rung's slot count becomes a FLOOR: the slow rule may only
   move to rungs that keep at least that many slots (otherwise overflow
   and slowness alternate and the controller thrashes between rungs).
   The floor clears once the device has been both clean and comfortable
   for a full clean streak.
 - EMA < ``low_water`` x budget and no overflow for ``clean_obs``
   observations -> recover toward the CONFIGURED rung (``home``): step up
   when below it; step back down (after a much longer clean streak) when an
   overflow excursion left us on a roomier-than-configured rung.  The
   controller never "improves" past the operating point the user tuned.
"""

from __future__ import annotations

from dataclasses import dataclass

_FMT_BYTES = {"f32": 4.0, "i16": 2.0, "i8bf": 1.002}  # i8bf: +4 B scale / W samples


@dataclass(frozen=True)
class Rung:
    slots: int
    fmt: str  # 'f32' | 'i16' | 'i8bf'

    def cost(self, wave_batch: int = 2000) -> float:
        """Approximate fetch bytes per block."""
        return self.slots * wave_batch * _FMT_BYTES[self.fmt]

    def __str__(self) -> str:
        return f"{self.slots} slots/{self.fmt}"


def default_ladder(base_slots: int, base_fmt: str = "i16") -> list[Rung]:
    """Best-first ladder around a configured operating point: one roomier
    rung above (overflow headroom), cheaper formats and a half-slots
    emergency rung below."""
    fmts = ["f32", "i16", "i8bf"]
    fi = fmts.index(base_fmt) if base_fmt in fmts else 1
    ladder = [Rung(base_slots * 2, fmts[min(fi + 1, 2)]), Rung(base_slots, base_fmt)]
    for f in fmts[fi + 1 :]:
        ladder.append(Rung(base_slots, f))
    ladder.append(Rung(max(1, base_slots // 2), "i8bf"))
    # de-dup while preserving order (base_fmt may already be i8bf)
    seen, out = set(), []
    for r in ladder:
        if (r.slots, r.fmt) not in seen:
            seen.add((r.slots, r.fmt))
            out.append(r)
    return out


class FetchEconomy:
    """Pure policy: feed it per-observation measurements via
    :meth:`observe`; it returns the new rung index when a shift is decided
    (apply it to the pipeline and log), else None.  No jax, no clocks —
    unit-testable with a synthetic drift trace (tests/test_economy.py)."""

    def __init__(
        self,
        rungs: list[Rung],
        start: int,
        block_budget_ms: float = 125.0,
        high_water: float = 0.90,
        low_water: float = 0.55,
        ema_alpha: float = 0.15,
        cooldown_obs: int = 4,
        overflow_obs: int = 2,
        slow_obs: int = 2,
        clean_obs: int = 12,
    ):
        if not rungs:
            raise ValueError("empty ladder")
        self.rungs = rungs
        self.idx = self.home = max(0, min(start, len(rungs) - 1))
        self.budget = float(block_budget_ms)
        self.high = high_water * self.budget
        self.low = low_water * self.budget
        self.alpha = ema_alpha
        self.cooldown_obs = cooldown_obs
        self.overflow_obs = overflow_obs
        self.slow_obs = slow_obs
        self.clean_obs = clean_obs
        self.ema_ms: float | None = None
        self._since_shift = 10**9
        self._overflow_streak = 0
        self._slow_streak = 0
        self._clean_streak = 0
        self._slots_floor = 0
        self.shift_count = 0

    @property
    def rung(self) -> Rung:
        return self.rungs[self.idx]

    def observe(self, ms_per_block: float, overflow_delta: int) -> int | None:
        """One observation (typically one handled chunk).  Returns the new
        rung index if the controller decides to shift, else None."""
        e = self.ema_ms
        self.ema_ms = ms_per_block if e is None else e + self.alpha * (ms_per_block - e)
        self._since_shift += 1
        if overflow_delta > 0:
            self._overflow_streak += 1
            self._clean_streak = 0
        else:
            self._overflow_streak = 0
            self._clean_streak += 1
        self._slow_streak = self._slow_streak + 1 if self.ema_ms > self.high else 0
        if self._clean_streak >= self.clean_obs and self.ema_ms < self.low:
            self._slots_floor = 0  # clean AND comfortable: the burst is over
        if self._since_shift < self.cooldown_obs:
            return None

        cur = self.rungs[self.idx]
        # 1) sustained slot overflow: audio is being shed RIGHT NOW — find
        #    the cheapest rung that keeps more channels per block, and pin
        #    that slot count as a floor against the slow rule
        if self._overflow_streak >= self.overflow_obs:
            cands = [i for i, r in enumerate(self.rungs) if r.slots > cur.slots]
            if cands:
                tgt = min(cands, key=lambda i: self.rungs[i].cost())
                self._slots_floor = self.rungs[tgt].slots
                return self._shift(tgt)
            self._overflow_streak = 0  # already at max slots; nothing to do
            return None
        # 2) persistently behind the block budget: cheaper bytes (a single
        #    bad chunk never shifts — the EMA must stay high for slow_obs);
        #    never shed below the overflow floor
        if self._slow_streak >= self.slow_obs:
            cands = [j for j in range(self.idx + 1, len(self.rungs)) if self.rungs[j].slots >= self._slots_floor]
            if cands:
                return self._shift(cands[0])
        # 3) comfortable and clean for a while: recover toward home — never
        #    past the configured operating point
        if self.ema_ms < self.low and self._clean_streak >= self.clean_obs:
            if self.idx > self.home:
                return self._shift(self.idx - 1)
            if self.idx < self.home and self._clean_streak >= 4 * self.clean_obs:
                return self._shift(self.idx + 1)
        return None

    def _shift(self, new_idx: int) -> int:
        self.idx = new_idx
        self._since_shift = 0
        self._overflow_streak = 0
        self._slow_streak = 0
        self._clean_streak = 0
        self.shift_count += 1
        return new_idx

    def neighbors(self) -> list[int]:
        """Rung indices worth pre-warming from the current position."""
        return [i for i in (self.idx - 1, self.idx + 1) if 0 <= i < len(self.rungs)]
