"""Device kernels launched per streamed fragment, from the traced fragments."""


def read(ctx):
    tr = ctx.get("trace")
    if ctx.get("kind") != "stream" or tr is None or not tr.kernels:
        return None
    return len(tr.kernels) / ctx["units_traced"]
