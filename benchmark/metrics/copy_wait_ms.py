"""Host time a block waiting for a chunk's device-to-host copy to land
(``Pipeline._to_host``'s ``pipeline.copy_wait`` spans)."""

from benchmark.program_trace import span_ms_per_block


def read(ctx):
    return span_ms_per_block(ctx, "pipeline.copy_wait")
