"""The yardstick's arithmetic: the H100's published peaks, the operations of
a forward solve and of a certified cell counted from shapes, and the
least time a K1 or K3 launch could take.

Copied, at commit 08631d7, from ``fiode_tpu_torch/bench.py`` (``work``),
``fiode_tpu_torch/bench_certify.py`` (``flops_per_cell``) and
``fiode_tpu_torch/_bench_common.py`` (``bound_ms``, ``conv_bound``,
``rhs_flops``, ``rhs_bound``), with one change: the products' flop leg of
a bound is taken at the TF32 dense peak (495 TFLOP/s) and not at the
3xTF32 rate (a third of it), so that no implementation, in any precision,
can read above 100% of its roofline.  Bytes stay at 3.35 TB/s and the
RHS's bisection at the float32 rate of 67 TFLOP/s.
"""
from __future__ import annotations

# the H100 SXM's published dense peaks at its 700 W limit (NVIDIA data
# sheet): float32 outside the tensor cores, TF32 on them, HBM3
FP32_FLOPS, TF32_FLOPS, HBM_BYTES = 67e12, 495e12, 3.35e12

__all__ = ["FP32_FLOPS", "TF32_FLOPS", "HBM_BYTES", "solve_work",
           "flops_per_cell", "bound_ms", "conv_bound", "rhs_flops",
           "rhs_bound", "conv_shapes"]


def conv_shapes(cfg: dict) -> list:
    """(ci, co, n) of each KWLarge Cayley conv as K3 applies it: a strided
    conv is a space_to_depth (4 ci channels at n / 2) then a stride-1 conv."""
    n, w, c = cfg["img_size"], cfg["width"], cfg["in_channels"]
    out = []
    for stride, co in ((1, 32 * w), (2, 32 * w), (1, 64 * w), (2, 64 * w)):
        n //= stride
        ci = c * stride * stride
        out.append((ci, co, n))
        c = co
    return out


def solve_work(cfg: dict) -> dict:
    """Flops of the forward solve from the configuration's shapes:
    ``per_image`` the four conv mixes (8 F co ci each, F = n (n / 2 + 1);
    the Fourier transforms are not counted), the three Cayley linears
    (2 in out) and the input injection (2 x_dim mlp); ``per_sample_nfe``
    one RHS evaluation, its three products and its bisection.  Left out:
    the weight-side Cayley transforms (once a forward, independent of the
    batch) and elementwise work."""
    conv = sum(8 * n * (n // 2 + 1) * co * ci for ci, co, n in conv_shapes(cfg))
    w, img = cfg["width"], cfg["img_size"]
    flat = 64 * w * (img // 4) ** 2
    linear = 2 * (flat * 512 * w + 512 * w * 512 + 512 * cfg["x_dim"])
    inject = 2 * cfg["x_dim"] * cfg["mlp_size"]
    products, bisection = rhs_flops(cfg["n_hidden"], cfg["mlp_size"],
                                    cfg["qp_iters"])
    return {"per_image": conv + linear + inject,
            "per_sample_nfe": products + bisection}


def flops_per_cell(n: int, m: int, qp_iters: int) -> int:
    """Flops of one (image, grid cell) of a CROWN block: CROWN's products
    (layer 1's centre; layer 2's collapsed sign split; layer 3's relaxation
    einsums, forms and concretisation) and the interval QP's 2 n cone
    projections of n lanes, 3 flops a lane and step."""
    layer1 = 2 * n * m
    layer2 = 2 * 2 * m * m + 2 * 2 * n * m * m + 2 * 2 * n * m
    layer3 = (2 * 12 * n * m + 2 * 2 * n * m * m + 2 * 2 * n * n * m
              + 2 * 2 * n * n)
    return layer1 + layer2 + layer3 + 2 * n * 3 * n * qp_iters


def bound_ms(n_bytes: float, flops: float, rate: float = TF32_FLOPS) -> float:
    """Least milliseconds: bytes over the memory rate or flops at ``rate``,
    whichever is longer."""
    return 1e3 * max(n_bytes / HBM_BYTES, flops / rate)


def conv_bound(B: int, ci: int, co: int, n: int) -> float:
    """Least ms of one K3 apply: x and y once, Q once; the mix's 8 F co ci
    flops per image at the TF32 peak."""
    F = n * (n // 2 + 1)
    return bound_ms(4 * B * (ci + co) * n * n + 8 * F * co * ci,
                    8 * B * F * co * ci)


def rhs_flops(n: int, m: int, qp_iters: int) -> tuple:
    """(products, bisection) flops per row of one K1 launch."""
    return 2 * n * m + 2 * m * m + 2 * m * n, 3 * n * qp_iters


def rhs_bound(B: int, n: int, m: int, qp_iters: int) -> float:
    """Least ms of one K1 launch: rows and weights once over the memory
    rate; the products at the TF32 peak plus the bisection at the float32
    rate."""
    weights = 4 * (2 * m * n + m * m + m + n)
    rows = 4 * B * (n + m + n)
    products, bisection = rhs_flops(n, m, qp_iters)
    return 1e3 * max((rows + weights) / HBM_BYTES,
                     B * (products / TF32_FLOPS + bisection / FP32_FLOPS))
