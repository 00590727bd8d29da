"""The whole training step's share of the card's peak: the operations one
step needs, counted on the reference at the cell's shapes (forward and
backward, no recomputation), times the window's steps, over the untraced
window's seconds and the configuration's stated peak, in %."""


def read(ctx):
    if ctx.get("kind") != "train" or not ctx.get("flops_per_unit"):
        return None
    return 100.0 * ctx["flops_per_unit"] * ctx["units"] / ctx["window_s"] / ctx["peak_flops"]
