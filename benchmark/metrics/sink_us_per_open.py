"""The block handler's fan-out a channel-block: the window's ``app.sinks``
spans (the open channels' and idle ticks' ``process`` calls, and the
submit) over the open channels they served (``app.open_channels``), in
microseconds; it stays comparable when the open count drifts."""

from benchmark.program_trace import span_ns, window_count


def read(ctx):
    t, n = span_ns(ctx, "app.sinks"), window_count(ctx, "app.open_channels")
    if t is None or not n:
        return None
    return t * 1e-3 / n
