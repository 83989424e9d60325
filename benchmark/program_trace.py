"""What the per-layer readers take from the program's own recorder
(``rtlsdr_airband_tpu_torch/runtime/trace.py``): its span records and
counter increments inside the traced window.

The recorder runs while the profiler records, so a run without a device
trace (``--trace 0``, the CPU) has nothing here, and a program without the
recorder has nothing either: every function returns None then, and raises
nothing.
"""

from __future__ import annotations


def recorder():
    """The program's recorder module, or None where the program has none."""
    try:
        from rtlsdr_airband_tpu_torch.runtime import trace
    except ImportError:
        return None
    return trace


def window_ns(ctx) -> tuple[int, int] | None:
    """The traced window [start, end] in ``perf_counter_ns`` nanoseconds."""
    if ctx.trace_result is None or ctx.window_start is None or not ctx.blocks_in_window:
        return None
    t0 = int(ctx.window_start * 1e9)
    return t0, t0 + int(ctx.trace_result.window_s * 1e9)


def window_records(ctx) -> list[tuple] | None:
    """The span records that start inside the window."""
    trace, win = recorder(), window_ns(ctx)
    if trace is None or win is None:
        return None
    recs = [r for r in trace.records() if win[0] <= r[1] <= win[1]]
    return recs or None


def window_count(ctx, name: str) -> int | None:
    """The sum of the counter's increments inside the window."""
    trace, win = recorder(), window_ns(ctx)
    if trace is None or win is None:
        return None
    return trace.counters(*win).get(name)


def span_ns(ctx, name: str) -> int | None:
    """The summed duration of the window's ``name`` spans."""
    recs = [r for r in window_records(ctx) or () if r[0] == name]
    return sum(r[2] - r[1] for r in recs) if recs else None


def span_ms_per_block(ctx, name: str) -> float | None:
    """Milliseconds a block in the window's ``name`` spans."""
    t = span_ns(ctx, name)
    return None if t is None else t * 1e-6 / ctx.blocks_in_window
