"""The block's assembly after K1 on the card: the profiler's device time of
the fade-tail kernel (every operation whose name holds ``fade_tail``) a
block of the window, in milliseconds; None without a device trace or
without the kernel (a program that assembles the block in plain tensor
operations).  ``fade_ms.app`` reads the same in the App's cells."""

from benchmark.metrics_common import device_seconds


def read(ctx):
    t = device_seconds(ctx, lambda name: "fade_tail" in name.lower())
    if t is None or not ctx.blocks_in_window:
        return None
    return 1e3 * t / ctx.blocks_in_window
