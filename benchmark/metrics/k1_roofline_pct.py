"""K1's share of its roofline: the least time the card could take for a
block's demod (``metrics_common.k1_bound_s``, from the shapes) over the
profiler's device time of the demod kernels a block."""

from benchmark.metrics_common import device_seconds, k1_bound_s


def read(ctx):
    t = device_seconds(ctx, lambda name: "demod" in name.lower())
    if t is None or not ctx.blocks_in_window:
        return None
    c = ctx.counters
    return 100.0 * k1_bound_s(c["W"], c["C"], c["n_ctcss"]) / (t / ctx.blocks_in_window)
