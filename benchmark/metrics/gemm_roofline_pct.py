"""The channelizer's GEMMs' share of their roofline: 4 products of [W, N] by
[N, C], 2 W N C operations each, at float32's 67 TFLOP/s, over the
profiler's device time of the GEMM kernels a block."""

from benchmark.metrics_common import FP32_FLOPS, device_seconds


def read(ctx):
    t = device_seconds(ctx, lambda name: "gemm" in name.lower() or "gemv" in name.lower())
    if t is None or not ctx.blocks_in_window:
        return None
    c = ctx.counters
    return 100.0 * (4 * 2 * c["W"] * c["N"] * c["C"] / FP32_FLOPS) / (t / ctx.blocks_in_window)
