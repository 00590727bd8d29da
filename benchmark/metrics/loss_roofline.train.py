"""The fused loss kernels' share of their roofline in a training step
(``ops/fused_loss.py``: ``loss_kernel`` at each level, ``loss_bwd_kernel``
once): the least time their bytes need at the HBM peak
(``yardstick.loss_least_seconds``) over their device time in the trace, in %.
Nothing to read where the trace holds neither kernel."""


def read(ctx):
    tr = ctx.get("trace")
    if ctx.get("kind") != "train" or tr is None:
        return None
    t = tr.kernel_seconds(("loss_kernel", "loss_bwd_kernel"))
    if t <= 0:
        return None
    return 100.0 * ctx["loss_least_s"] * ctx["units_traced"] / t
