"""The App's single loop over its devices: host time a block of air in the
window's ``app.round`` spans (a pass of ``App._service_once`` over every
device), in milliseconds; None from a program without the span.  The entry
reports the counter ``app.devices_serviced`` a round beside it
(``devices_serviced_per_round``)."""

from benchmark.program_trace import span_ms_per_block


def read(ctx):
    return span_ms_per_block(ctx, "app.round")
