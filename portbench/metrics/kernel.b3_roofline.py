"""kernel.b3_roofline: B3's share of its roofline, in %: the least time
the card could take for the folded DFT products of one stream step's
frames, both ways (`b3_stream_step`; operations set the bound, 3xTF32
counted as three TF32 products), over the device time a step of B3's
launches in the trace: `rt_fold_kernel` and both `rt_gemm_kernel`s (the
masked stream's frames-only call; B2 is the same three kernels with B1
after them, and runs in no stream). Nothing when the trace holds no such
launch."""

from portbench import trace, work

NAMES = ("rt_fold_kernel", "rt_gemm_kernel")


def b3_stream_step(config: dict, channels: int, chunk: int) -> dict:
    """B3 over one stream step: the frames of the context-extended chunk
    (the chunk with ceil(N/H)*H samples of context on each side, a frame
    every H samples), N^2 MACs a frame (the folded forward and inverse
    products); the extended chunk read and the frames written once."""
    n, hop = config["frame_size"], config["hop_size"]
    ext = chunk + 2 * (-(-n // hop) * hop)
    frames = ext // hop
    macs = channels * frames * n * n
    data = channels * ext * work.F32 + channels * frames * n * work.F32
    return {"ops": 2 * macs * work.TF32_PASSES[config["precision"]],
            "bytes": data}


def read(ctx):
    s = ctx["summary"]
    if s is None:
        return None
    t = trace.seconds_matching(s, NAMES) / s["steps"]
    if t <= 0:
        return None
    c = ctx["cell"].config
    w = b3_stream_step(c, c["channels"], c["chunk_samples_per_card"])
    bound, _ = work.bound_s(w, ctx["peaks"])
    return 100.0 * bound / t
