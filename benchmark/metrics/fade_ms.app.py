"""``fade_ms.block`` in the App's cells, where it moves ``card_ms.app``: the
fade-tail kernel's device time a block of the window, in milliseconds, read
by ``fade_ms.block.py``'s own code."""

from benchmark.harness import HERE, load_module

read = load_module(HERE / "metrics" / "fade_ms.block.py", "benchmark_metric_fade_ms_block").read
