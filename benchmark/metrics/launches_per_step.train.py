"""Device kernels launched per training step, from the traced steps."""


def read(ctx):
    tr = ctx.get("trace")
    if ctx.get("kind") != "train" or tr is None or not tr.kernels:
        return None
    return len(tr.kernels) / ctx["units_traced"]
