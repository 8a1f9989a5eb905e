"""The window's CROWN blocks as a share of the H100's TF32 dense peak, in
percent: ``work.flops_per_cell`` x image-cells over the window's seconds."""
from perfbench import work


def read(ctx):
    w, c = ctx.state.window, ctx.config
    per_cell = work.flops_per_cell(c["n_hidden"], c["mlp_size"], c["qp_iters"])
    return 100.0 * w["items"] * per_cell / w["seconds"] / work.TF32_FLOPS
