"""Seconds of set-up spent building the App from its configuration (the
``setup.app`` span: output sets, Pipeline, input), not clipped to the
window; the newest App built before the window."""

from benchmark.program_trace import recorder, window_ns


def read(ctx):
    trace, win = recorder(), window_ns(ctx)
    if trace is None or win is None:
        return None
    recs = [r for r in trace.records() if r[0] == "setup.app" and r[1] <= win[0]]
    return (recs[-1][2] - recs[-1][1]) * 1e-9 if recs else None
