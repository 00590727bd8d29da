"""The whole fragment's share of the card's peak: the operations of one
fragment's forward pass counted on the reference, times the window's
fragments, over the untraced window's seconds and the configuration's stated
peak, in %."""


def read(ctx):
    if ctx.get("kind") != "stream" or not ctx.get("flops_per_unit"):
        return None
    return 100.0 * ctx["flops_per_unit"] * ctx["units"] / ctx["window_s"] / ctx["peak_flops"]
