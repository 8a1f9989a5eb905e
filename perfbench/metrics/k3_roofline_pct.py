"""K3 (ops/fused_cayley_conv, csrc/fused_cayley_conv.cu) against its
roofline, in percent: the least time of the slice's applies from their
shapes (``work.conv_bound``: each input byte read once, each output byte
written once, the mix's flops at the TF32 peak) over the device time of
K3's kernels by name in the profiled slice."""
from perfbench import work

TAGS = ("rdft_", "mix_kernel")


def read(ctx):
    p = ctx.profile
    if p is None:
        return None
    ms, _ = p.device_ms(TAGS)
    if ms <= 0:
        return None
    B = ctx.mix["batch"]
    bound = sum(work.conv_bound(B, ci, co, n)
                for ci, co, n in work.conv_shapes(ctx.config))
    return 100.0 * p.iterations * bound / ms
