"""The App's input a megabyte: the window's ``app.ring_read`` and
``pipeline.ingest`` spans over the raw bytes ``Pipeline.feed`` took in it
(``pipeline.ingest_bytes``, in MB), in microseconds; it stays comparable
between a 640 kB block (u8 at 2.56 Msps) and a 5 MB one (s8 at 20 Msps)."""

from benchmark.program_trace import span_ns, window_count


def read(ctx):
    ring, ingest = span_ns(ctx, "app.ring_read"), span_ns(ctx, "pipeline.ingest")
    n = window_count(ctx, "pipeline.ingest_bytes")
    if (ring is None and ingest is None) or not n:
        return None
    return ((ring or 0) + (ingest or 0)) * 1e-3 / (n * 1e-6)
