"""kernel.b2_roofline: B2's share of its roofline, in %: the least time
the card could take for the folded DFT products of every frame of a clip,
both ways (`work.b2_clip`; operations set the bound, 3xTF32 counted as
three TF32 products), over the device time a call of B2's launches in the
trace: `rt_fold_kernel` and both `rt_gemm_kernel`s. Nothing when the
trace holds no B2 launch."""

from portbench import trace, work


NAMES = ("rt_fold_kernel", "rt_gemm_kernel")


def read(ctx):
    s = ctx["summary"]
    if s is None:
        return None
    t = trace.seconds_matching(s, NAMES) / s["steps"]
    if t <= 0:
        return None
    cell = ctx["cell"]
    c = cell.config
    bound, _ = work.bound_s(work.b2_clip(c, c["channels"], c["samples"]),
                            ctx["peaks"])
    return 100.0 * bound / t
