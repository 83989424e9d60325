"""Host time a block taking the raw stream in: the window's ``app.ring_read``
spans (a block's bytes copied out of the device's ring) and
``pipeline.ingest`` spans (``Pipeline.feed`` appending them to the pending
stream, and decoding them on the host where they ship as float32 pairs),
over the window's blocks."""

from benchmark.program_trace import span_ns


def read(ctx):
    ring, ingest = span_ns(ctx, "app.ring_read"), span_ns(ctx, "pipeline.ingest")
    if ring is None and ingest is None:
        return None
    return ((ring or 0) + (ingest or 0)) * 1e-6 / ctx.blocks_in_window
