"""Demod K1 in an App of several devices: the profiler's device time of
every operation named ``demod`` (K1 and the CTCSS pass, over every device's
launches) a block of air of the window, in milliseconds; None without a
device trace."""

from benchmark.metrics_common import device_seconds


def read(ctx):
    t = device_seconds(ctx, lambda name: "demod" in name.lower())
    if t is None or not ctx.blocks_in_window:
        return None
    return 1e3 * t / ctx.blocks_in_window
