"""K1's share of its roofline in an App of several devices: the least time
the card could take for a block of air's demod launches, one a device at
its own channel count (``metrics_common.k1_bound_s``, summed over the
entry's counter ``k1_launches``), over ``demod_ms.devices``."""

from benchmark.harness import HERE, load_module
from benchmark.metrics_common import k1_bound_s

demod_ms = load_module(HERE / "metrics" / "demod_ms.devices.py", "benchmark_metric_demod_ms_devices").read


def read(ctx):
    ms, launches = demod_ms(ctx), ctx.counters.get("k1_launches")
    if ms is None or not launches:
        return None
    return 100.0 * sum(k1_bound_s(W, C, n_ctcss) for W, C, n_ctcss in launches) / (ms * 1e-3)
