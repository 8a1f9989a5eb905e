"""K1 (ops/fused_rhs, csrc/fused_rhs.cu) against its roofline, in percent:
the least time of the slice's launches, each on the batch's rows, from
their shapes (``work.rhs_bound``) over K1's device time by kernel name in
the profiled slice."""
from perfbench import work

TAGS = ("fused_rhs_kernel",)


def read(ctx):
    p = ctx.profile
    if p is None:
        return None
    ms, launches = p.device_ms(TAGS)
    if ms <= 0:
        return None
    c = ctx.config
    bound = work.rhs_bound(ctx.mix["batch"], c["n_hidden"], c["mlp_size"],
                           c["qp_iters"])
    return 100.0 * launches * bound / ms
