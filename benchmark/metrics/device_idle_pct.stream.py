"""The device's idle share of the traced fragments: 100 · (1 − the union of
its operations' intervals / the traced window)."""


def read(ctx):
    tr = ctx.get("trace")
    if ctx.get("kind") != "stream" or tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
