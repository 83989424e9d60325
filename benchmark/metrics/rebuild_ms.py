"""Host time a block in ``Pipeline._to_host``, less its wait for the copy."""


def read(ctx):
    s = ctx.spans.total
    if "rebuild" not in s or not ctx.blocks_in_window:
        return None
    return (s["rebuild"] - s.get("copy_wait", 0.0)) / ctx.blocks_in_window * 1e3
