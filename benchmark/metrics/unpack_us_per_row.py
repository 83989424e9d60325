"""The Framer's unpack a channel-block: the window's ``pipeline.dequant``
and ``pipeline.scatter`` spans (restoring the fetched slots, re-zeroing,
the row copies and the fade-tail synthesis) over the slot rows they
restored and copied (``pipeline.unpacked_rows``), in microseconds; it stays
comparable when the open count drifts."""

from benchmark.program_trace import span_ns, window_count


def read(ctx):
    dequant, scatter = span_ns(ctx, "pipeline.dequant"), span_ns(ctx, "pipeline.scatter")
    n = window_count(ctx, "pipeline.unpacked_rows")
    if scatter is None or not n:
        return None
    return ((dequant or 0) + scatter) * 1e-3 / n
