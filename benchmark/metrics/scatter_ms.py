"""Host time a block rebuilding the dense [W, C] audio from the fetched
slots: re-zeroing, the slot and IQ scatters and the fade-tail synthesis
(``Pipeline._to_host``'s ``pipeline.scatter`` spans, ``pipeline.fade`` in them)."""

from benchmark.program_trace import span_ms_per_block


def read(ctx):
    return span_ms_per_block(ctx, "pipeline.scatter")
