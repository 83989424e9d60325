"""Host time a block in ``Pipeline._dispatch`` (staging, the chain's launches)."""


def read(ctx):
    s = ctx.spans.total
    if "dispatch" not in s or not ctx.blocks_in_window:
        return None
    return s["dispatch"] / ctx.blocks_in_window * 1e3
