"""Host time a block in ``App._handle_block`` (the open channels' sinks)."""


def read(ctx):
    s = ctx.spans.total
    if "handler" not in s or not ctx.blocks_in_window:
        return None
    return s["handler"] / ctx.blocks_in_window * 1e3
