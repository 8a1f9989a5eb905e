"""The window's forward solves as a share of the H100's TF32 dense peak, in
percent: the flops counted from shapes (``work.solve_work``: per image and
per sample-NFE, the window's NFE summed) over the window's seconds."""
from perfbench import work


def read(ctx):
    w, flops = ctx.state.window, work.solve_work(ctx.config)
    B = ctx.mix["batch"]
    total = (w["attempted"] * B * flops["per_image"]
             + sum(w["nfe"]) * B * flops["per_sample_nfe"])
    return 100.0 * total / w["seconds"] / work.TF32_FLOPS
