"""The card's busy time a block in the App by the profiler's trace, over
the same chunks as ``card_ms.app`` (from the first chunk dispatched in the
window to the last): its kernels and copies without the waits for the
host's launches that ``card_ms.app`` holds."""


def read(ctx):
    return ctx.counters.get("card_busy_ms")
