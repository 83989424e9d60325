"""Host time a block restoring the fetched int8 or int16 audio to float32
(``Pipeline._to_host``'s ``pipeline.dequant`` spans, once a chunk)."""

from benchmark.program_trace import span_ms_per_block


def read(ctx):
    return span_ms_per_block(ctx, "pipeline.dequant")
