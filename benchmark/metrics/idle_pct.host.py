"""Share of the traced window in which no kernel or copy ran on the card."""

from benchmark.metrics_common import idle_pct as read  # noqa: F401
