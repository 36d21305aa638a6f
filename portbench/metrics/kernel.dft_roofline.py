"""kernel.dft_roofline: the folded DFT's share of its roofline, in %: the
least time the card could take for the folded DFT products of every frame
of a clip, both ways (`work.b2_clip`: N^2 MACs a frame, 3xTF32 counted as
three TF32 products at the TF32 peak, the count `kernel.b2_roofline`
uses), over the card's busy time a traced step. The denominator is the
whole step's device time and names no kernel, so the share reads the
same work whatever computes it: cuBLAS products on the "packed_parts"
route, B2, or a factored DFT. Nothing when the run is untraced."""

from portbench import work


def read(ctx):
    s = ctx["summary"]
    if s is None or not ctx["busy_s"]:
        return None
    c = ctx["cell"].config
    bound, _ = work.bound_s(work.b2_clip(c, c["channels"], c["samples"]),
                            ctx["peaks"])
    return 100.0 * bound / (ctx["busy_s"] / s["steps"])
