"""Air handled over the App's window by the host's clock, unpaced: seconds
of air a second.  Per layer, not end to end: the host's pace swings by a
sixth from run to run with its neighbours, more than any bound allows."""


def read(ctx):
    return ctx.e2e.get("realtime_x")
