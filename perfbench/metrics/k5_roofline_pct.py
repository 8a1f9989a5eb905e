"""K5 (ops/fused_qp, csrc/fused_qp.cu) against its roofline, in percent:
the least time of the slice's launches, each on a chunk's rows (images x
chunk cells), over K5's device time by kernel name in the profiled slice.
A launch's least time is the larger of its operations, 2 n projections of
n lanes at 3 a lane and halving (``work.flops_per_cell``'s QP term), at
the float32 rate, and its bytes, 4 n floats read and 2 n written a row, at
the memory rate.  None where the slice ran no K5 (a program without it)."""
from perfbench import work

TAGS = ("fused_cone_qp_kernel",)


def read(ctx):
    p = ctx.profile
    if p is None:
        return None
    ms, launches = p.device_ms(TAGS)
    if ms <= 0:
        return None
    c = ctx.config
    rows = ctx.mix["images"] * c["chunk"]
    n, iters = c["n_hidden"], c["qp_iters"]
    ops = rows * 2 * n * 3 * n * iters
    n_bytes = rows * 6 * n * 4
    bound_ms = 1e3 * max(ops / work.FP32_FLOPS, n_bytes / work.HBM_BYTES)
    return 100.0 * launches * bound_ms / ms
