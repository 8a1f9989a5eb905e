"""Fused ODE right-hand side (counterpart of ``fiode_tpu/ops/fused_rhs.py``).

``fused_rhs`` evaluates the projected simplex dynamics on densified weights:

    z1 = relu(h W1^T + xc);  z2 = relu(z1 W2^T + b2);  f = z2 W3^T + b3
    lower = -alpha_1 (exp(sigma_1 h) - 1)
    [scale_nominal]  f = (alpha_2 (1 - h) - lower) sigmoid(f) + lower
    out = simplex_cone_project(lower, f)

with ``xc = U x_feat + bU + b1`` computed once per solve.  The activation is
ReLU and there is no dropout: the caller rejects any other configuration.

On a CPU tensor it runs ``rhs_reference`` (plain PyTorch, differentiated by
autograd).  On a CUDA tensor it launches kernel K1 (``csrc/fused_rhs.cu``)
and its backward launches kernel K2 (``fused_rhs_vjp``, same source), whose
plain version is ``rhs_vjp_reference``; both cover scale_nominal off and on.
The state keeps its true width n: the TPU's 128-lane padding is not carried
over.

Both kernels are bound by operations (a flagship row moves 592 bytes forward
for ~36 kFLOP), most of them the mlp x mlp product, so the three products
(six in K2, nine with weight gradients) run on the tensor cores in 3xTF32
with the batch rows as M, a warp owning 16 rows and keeping their
activations in registers from one product to the next.  The weights reach a
block as one image, ``pack_rhs_params`` builds it once per solve
(``pack_weights``: zero padded to 8-row and 32-column multiples and
swizzled so that the forward's and the backward's fragment reads are both
free of bank conflicts), and ``RhsParams.packed`` carries it.  The kernels
are compiled per pair of tile counts (ceil(mlp / 8), ceil(n / 8)), one
library each, at first use.

What a block keeps in shared memory is that image, plus for K2 with weight
gradients two staging buffers of 16 rows per warp; K2 then runs with as many
warps (8, 4, 2 or 1) as fit.  A shape whose image alone exceeds a block's
shared memory is refused with a ``ValueError`` before any launch.  Within
n <= 128 and mlp <= 128, the JAX kernel's domain, nothing is refused.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from ..utils import tracing
from ._build import load_library
from .simplex_qp import cone_project_mu, simplex_cone_project

__all__ = ["RhsParams", "pack_rhs_params", "pack_weights", "pack_layout",
           "shared_memory_bytes", "rhs_reference", "rhs_vjp_reference",
           "staged_warps", "fused_rhs", "fused_rhs_vjp", "build"]

SMEM_LIMIT = 232448  # dynamic shared memory a block may have on sm_90
MAX_WARPS = 8        # warps of a block; each owns 16 batch rows at a time


class _RhsFields(NamedTuple):
    W1: torch.Tensor  # (mlp, n)
    W2: torch.Tensor  # (mlp, mlp)
    W3: torch.Tensor  # (n, mlp)
    b2: torch.Tensor  # (mlp,)
    b3: torch.Tensor  # (n,)


class RhsParams(_RhsFields):
    """The five dense weights, as a tuple; ``packed`` is their shared-memory
    image for the CUDA kernels (``pack_weights``), set by
    ``pack_rhs_params`` and derived at the launch when it is missing."""
    packed: Optional[torch.Tensor] = None


class PackLayout(NamedTuple):
    """Where ``pack_weights`` puts each weight: tile counts, padded sizes,
    row strides and offsets, in floats."""
    mt: int       # 8-column tiles of mlp
    nt: int       # 8-column tiles of n
    mp: int       # mlp rounded up to 8
    np: int       # n rounded up to 8
    s1: int       # row stride of W1: np rounded up to 32
    s2: int       # row stride of W2 and W3: mp rounded up to 32
    off_w2: int
    off_w3: int
    off_b2: int
    off_b3: int
    floats: int


@functools.lru_cache(maxsize=64)
def pack_layout(n: int, m: int) -> PackLayout:
    mt, nt = -(-m // 8), -(-n // 8)
    mp, np_ = 8 * mt, 8 * nt
    s1, s2 = -(-np_ // 32) * 32, -(-mp // 32) * 32
    off_w2 = mp * s1
    off_w3 = off_w2 + mp * s2
    off_b2 = off_w3 + np_ * s2
    off_b3 = off_b2 + mp
    return PackLayout(mt, nt, mp, np_, s1, s2, off_w2, off_w3, off_b2, off_b3,
                      off_b3 + np_)


def _odd8(x: int) -> int:
    """The staging buffers' row stride: x padded to an odd multiple of 8."""
    return x + 8 if (x // 8) % 2 == 0 else x + 16


@functools.lru_cache(maxsize=256)
def shared_memory_bytes(n: int, m: int, staged_warps: int = 0) -> int:
    """Shared memory of one block of K1 or K2 at state width n and MLP width
    m: the packed weights, and, where ``staged_warps`` warps stage their 16
    rows each for the weight gradients, the two staging buffers."""
    lay = pack_layout(n, m)
    sm, sn = _odd8(lay.mp), _odd8(lay.np)
    return 4 * (lay.floats + 16 * staged_warps * (sm + max(sm, sn)))


def swizzle(rows: torch.Tensor) -> torch.Tensor:
    """The column XOR of row r in the packed image: 8 ((r & 3) ^ (r >> 2 & 1))."""
    return ((rows & 3) ^ ((rows >> 2) & 1)) << 3


def _swizzled(W, rows: int, stride: int):
    """W zero padded to (rows, stride), element (r, c) at column
    c ^ swizzle(r) of row r."""
    padded = W.new_zeros((rows, stride))
    padded[:W.shape[0], :W.shape[1]] = W
    r = torch.arange(rows, device=W.device)[:, None]
    c = torch.arange(stride, device=W.device)[None, :]
    return padded.gather(1, c ^ swizzle(r))  # the XOR is its own inverse


def pack_weights(W1, W2, W3, b2, b3) -> torch.Tensor:
    """The image of the weights a block of K1 or K2 keeps in shared memory
    (``pack_layout``): [W1 (mp, s1) | W2 (mp, s2) | W3 (np, s2) | b2 (mp) |
    b3 (np)], float32, each matrix [out][in] row-major, zero padded and
    swizzled."""
    m, n = W1.shape
    lay = pack_layout(n, m)
    with torch.no_grad():
        return torch.cat([
            _swizzled(W1, lay.mp, lay.s1).reshape(-1),
            _swizzled(W2, lay.mp, lay.s2).reshape(-1),
            _swizzled(W3, lay.np, lay.s2).reshape(-1),
            torch.nn.functional.pad(b2, (0, lay.mp - m)),
            torch.nn.functional.pad(b3, (0, lay.np - n)),
        ]).to(torch.float32).contiguous()


def pack_rhs_params(W1, W2, W3, b2, b3) -> RhsParams:
    """Dense dynamics weights as contiguous float32 tensors, with their
    packed image for the kernels where they lie on a CUDA device."""
    p = RhsParams(*(t.to(torch.float32).contiguous()
                    for t in (W1, W2, W3, b2, b3)))
    if p.W1.device.type == "cuda":
        p.packed = pack_weights(*p)
    return p


def rhs_reference(h, xc, p: RhsParams, alpha_1, sigma_1, alpha_2,
                  scale_nominal: bool = False, qp_iters: int = 30):
    """Plain PyTorch version of kernel K1: (B, n), (B, mlp) -> (B, n)."""
    z1 = torch.relu(h @ p.W1.T + xc)
    z2 = torch.relu(z1 @ p.W2.T + p.b2)
    f_tilde = z2 @ p.W3.T + p.b3
    lower = -alpha_1 * (torch.exp(sigma_1 * h) - 1.0)
    if scale_nominal:
        upper = alpha_2 * (1.0 - h)
        f_tilde = (upper - lower) * torch.sigmoid(f_tilde) + lower
    return simplex_cone_project(lower, f_tilde, qp_iters)


def rhs_vjp_reference(h, xc, g, p: RhsParams, alpha_1, sigma_1, alpha_2,
                      scale_nominal: bool = False, qp_iters: int = 30
                      ) -> Tuple[torch.Tensor, torch.Tensor, RhsParams]:
    """Plain PyTorch version of kernel K2: the VJP of ``rhs_reference`` at
    cotangent g (B, n), written out.

    Returns (dh (B, n), dxc (B, mlp), RhsParams of the weight gradients
    summed over the batch)."""
    z1 = torch.relu(h @ p.W1.T + xc)
    z2 = torch.relu(z1 @ p.W2.T + p.b2)
    f_tilde = z2 @ p.W3.T + p.b3
    lower = -alpha_1 * (torch.exp(sigma_1 * h) - 1.0)
    f = f_tilde
    if scale_nominal:
        upper = alpha_2 * (1.0 - h)
        s = torch.sigmoid(f_tilde)
        f = (upper - lower) * s + lower
    mu = cone_project_mu(lower, f, qp_iters)
    # active-set VJP of the cone projection (the branch the clamp took)
    active = (f - mu) < lower
    free = ~active
    n_free = free.sum(-1, keepdim=True).to(g.dtype).clamp_min(1.0)
    corr = torch.where(free, g, 0.0).sum(-1, keepdim=True) / n_free
    d_f = torch.where(free, g - corr, 0.0)
    d_lower = torch.where(active, g - corr, 0.0)
    d_ft, dh_upper = d_f, 0.0
    if scale_nominal:  # through f = (upper - lower) s + lower
        d_ft = d_f * (upper - lower) * s * (1.0 - s)
        d_lower = d_lower + d_f * (1.0 - s)
        dh_upper = -alpha_2 * d_f * s
    d_pre2 = torch.where(z2 > 0, d_ft @ p.W3, 0.0)
    d_pre1 = torch.where(z1 > 0, d_pre2 @ p.W2, 0.0)
    dh = (d_lower * (-alpha_1 * sigma_1 * torch.exp(sigma_1 * h)) + dh_upper
          + d_pre1 @ p.W1)
    dp = RhsParams(d_pre1.T @ h, d_pre2.T @ z1, d_ft.T @ z2, d_pre2.sum(0),
                   d_ft.sum(0))
    return dh, d_pre1, dp


@functools.cache
def _lib(mt: int, nt: int):
    """The kernels compiled for mt = ceil(mlp / 8), nt = ceil(n / 8)."""
    lib = load_library("fused_rhs", (("FIODE_RHS_MT", mt), ("FIODE_RHS_NT", nt)))
    fn = lib.fused_rhs_forward
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                   + [ctypes.c_float] * 3 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    fn = lib.fused_rhs_backward
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                   + [ctypes.c_float] * 3 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    for name in ("fused_rhs_mlp_tiles", "fused_rhs_state_tiles",
                 "fused_rhs_pack_floats"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
    lib.fused_rhs_smem_bytes.argtypes = [ctypes.c_int]
    lib.fused_rhs_smem_bytes.restype = ctypes.c_longlong
    lib.fused_rhs_smem_limit.argtypes = []
    lib.fused_rhs_smem_limit.restype = ctypes.c_longlong
    lib.fused_rhs_grad_floats.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.fused_rhs_grad_floats.restype = ctypes.c_int
    lib.fused_rhs_error_string.argtypes = [ctypes.c_int]
    lib.fused_rhs_error_string.restype = ctypes.c_char_p
    # the source and this module lay the weights out independently
    n, m = 8 * nt, 8 * mt
    lay = pack_layout(n, m)
    got = (lib.fused_rhs_mlp_tiles(), lib.fused_rhs_state_tiles(),
           lib.fused_rhs_pack_floats(), lib.fused_rhs_smem_limit(),
           *(lib.fused_rhs_smem_bytes(w) for w in (0, 1, MAX_WARPS)))
    want = (mt, nt, lay.floats, SMEM_LIMIT,
            *(shared_memory_bytes(n, m, w) for w in (0, 1, MAX_WARPS)))
    if got != want:
        raise RuntimeError(f"fused_rhs library built for {got}, the wrapper "
                           f"expects {want}")
    return lib


def build(n: int, m: int):
    """Compile (or load) the kernels for state width n and MLP width m."""
    lay = pack_layout(n, m)
    return _lib(lay.mt, lay.nt)


@functools.lru_cache(maxsize=8)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check(name, h, want):
    for arg, (t, shape) in want.items():
        if (t.device != h.device or t.dtype != torch.float32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(
                f"{name}: {arg} must be a contiguous float32 {shape} "
                f"tensor on {h.device}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}"
            )


def _check_smem(name, n, m):
    """Refuse, before the build and the launch, a shape whose packed weights
    do not fit in one block's shared memory."""
    need = shared_memory_bytes(n, m)
    if need > SMEM_LIMIT:
        raise ValueError(
            f"{name}: n = {n}, mlp = {m} needs {need} bytes of shared memory "
            f"per block for the packed weights, more than the {SMEM_LIMIT} a "
            f"block can have"
        )


@functools.lru_cache(maxsize=64)
def staged_warps(n: int, m: int) -> int:
    """Warps of a block of K2 with weight gradients: the most of 8, 4, 2, 1
    whose staging buffers fit beside the packed weights (0: not even one)."""
    for warps in (8, 4, 2, 1):
        if shared_memory_bytes(n, m, warps) <= SMEM_LIMIT:
            return warps
    return 0


def _free_warps(B: int, device) -> int:
    """Warps of a block whose warps walk 16-row tiles on their own (K1, and
    K2 without weight gradients): enough to cover the batch with one block
    per SM, at most 8."""
    tiles = -(-B // 16)
    return max(1, min(MAX_WARPS, -(-tiles // _sm_count(device))))


def _want(h, xc, p: RhsParams):
    B, n = h.shape
    m = p.W2.shape[0]
    return {"h": (h, (B, n)), "xc": (xc, (B, m)), "W1": (p.W1, (m, n)),
            "W2": (p.W2, (m, m)), "W3": (p.W3, (n, m)), "b2": (p.b2, (m,)),
            "b3": (p.b3, (n,))}


def _packed(name, p: RhsParams, n, m) -> torch.Tensor:
    """p's packed image, checked; derived and kept on p if it has none."""
    if p.packed is None:
        p.packed = pack_weights(*p)
    packed = p.packed
    floats = pack_layout(n, m).floats
    if (packed.device != p.W1.device or packed.dtype != torch.float32
            or tuple(packed.shape) != (floats,) or not packed.is_contiguous()
            or packed.data_ptr() % 16):
        raise ValueError(f"{name}: packed weights must be a contiguous, "
                         f"16-byte aligned float32 ({floats},) tensor on "
                         f"{p.W1.device}")
    return packed


def _raise_on(lib, rc, what):
    if rc != 0:
        msg = lib.fused_rhs_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel failed: {msg}")


def _launch(h, xc, p: RhsParams, alpha_1, sigma_1, alpha_2, scale_nominal,
            qp_iters):
    _check("fused_rhs", h, _want(h, xc, p))
    B, n = h.shape
    m = p.W2.shape[0]
    _check_smem("fused_rhs", n, m)
    packed = _packed("fused_rhs", p, n, m)
    lib = build(n, m)
    out = torch.empty_like(h)
    rc = lib.fused_rhs_forward(
        h.data_ptr(), xc.data_ptr(), packed.data_ptr(), out.data_ptr(),
        B, n, m, float(alpha_1), float(sigma_1), float(alpha_2),
        int(bool(scale_nominal)), int(qp_iters), _free_warps(B, h.device),
        torch.cuda.current_stream(h.device).cuda_stream,
    )
    _raise_on(lib, rc, "fused_rhs")
    tracing.count("k1.launches")
    return out


def _launch_vjp(h, xc, g, p: RhsParams, alpha_1, sigma_1, alpha_2,
                scale_nominal, qp_iters, weight_grads):
    want = _want(h, xc, p)
    want["g"] = (g, tuple(h.shape))
    _check("fused_rhs_vjp", h, want)
    B, n = h.shape
    m = p.W2.shape[0]
    _check_smem("fused_rhs_vjp", n, m)
    warps = _free_warps(B, h.device)
    if weight_grads:
        warps = staged_warps(n, m)
        if warps == 0:
            raise ValueError(
                f"fused_rhs_vjp: n = {n}, mlp = {m} with weight gradients "
                f"needs {shared_memory_bytes(n, m, 1)} bytes of shared "
                f"memory per block for the packed weights and one warp's "
                f"staging buffers, more than the {SMEM_LIMIT} a block can "
                f"have"
            )
    packed = _packed("fused_rhs_vjp", p, n, m)
    lib = build(n, m)
    dh = torch.empty_like(h)
    dxc = torch.empty_like(xc)
    dw = ws = None
    slots = 0
    if weight_grads:
        floats = lib.fused_rhs_grad_floats(n, m)
        slots = _sm_count(h.device)  # at most one block (and slot) per SM
        dw = torch.empty(floats, device=h.device, dtype=torch.float32)
        ws = torch.empty((slots, floats), device=h.device, dtype=torch.float32)
    rc = lib.fused_rhs_backward(
        h.data_ptr(), xc.data_ptr(), g.data_ptr(), packed.data_ptr(),
        dh.data_ptr(), dxc.data_ptr(),
        None if dw is None else dw.data_ptr(),
        None if ws is None else ws.data_ptr(), slots, B, n, m,
        float(alpha_1), float(sigma_1), float(alpha_2),
        int(bool(scale_nominal)), int(qp_iters), warps,
        torch.cuda.current_stream(h.device).cuda_stream,
    )
    _raise_on(lib, rc, "fused_rhs_vjp")
    tracing.count("k2.launches")
    if dw is None:
        return dh, dxc, None
    sizes = (m * n, m * m, n * m, m, n)
    shapes = ((m, n), (m, m), (n, m), (m,), (n,))
    parts = torch.split(dw, sizes)
    return dh, dxc, RhsParams(*(t.view(s) for t, s in zip(parts, shapes)))


def fused_rhs_vjp(h, xc, g, p: RhsParams, alpha_1, sigma_1, alpha_2,
                  scale_nominal: bool = False, qp_iters: int = 30,
                  weight_grads: bool = True
                  ) -> Tuple[torch.Tensor, torch.Tensor, Optional[RhsParams]]:
    """VJP of ``fused_rhs`` at cotangent g (B, n): (dh, dxc, weight
    gradients or None when ``weight_grads`` is False).

    A CPU tensor takes ``rhs_vjp_reference``; a CUDA tensor launches K2
    (counted as ``k2.launches``, ``utils/tracing.py``) or raises.  Without
    weight gradients K2 has no staging buffers, no block-wide barrier and
    no reduction launch.
    """
    if h.device.type == "cpu":
        dh, dxc, dp = rhs_vjp_reference(h, xc, g, p, alpha_1, sigma_1,
                                        alpha_2, scale_nominal, qp_iters)
        return dh, dxc, dp if weight_grads else None
    if h.device.type != "cuda":
        raise ValueError(f"fused_rhs_vjp: unsupported device {h.device}")
    return _launch_vjp(h, xc, g, p, alpha_1, sigma_1, alpha_2, scale_nominal,
                       qp_iters, weight_grads)



class _FusedRhsCuda(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, xc, W1, W2, W3, b2, b3, packed, alpha_1, sigma_1,
                alpha_2, scale_nominal, qp_iters):
        ctx.save_for_backward(h, xc, W1, W2, W3, b2, b3)
        ctx.consts = (alpha_1, sigma_1, alpha_2, scale_nominal, qp_iters)
        p = RhsParams(W1, W2, W3, b2, b3)
        p.packed = packed
        out = _launch(h, xc, p, alpha_1, sigma_1, alpha_2, scale_nominal,
                      qp_iters)
        ctx.packed = p.packed  # derived by the launch if it was missing
        return out

    @staticmethod
    def backward(ctx, g):
        h, xc, *w = ctx.saved_tensors
        weight_grads = any(ctx.needs_input_grad[2:7])
        p = RhsParams(*w)
        p.packed = ctx.packed
        dh, dxc, dp = fused_rhs_vjp(h, xc, g.contiguous(), p, *ctx.consts,
                                    weight_grads)
        dw = tuple(dp) if dp is not None else (None,) * 5
        return (dh, dxc, *dw) + (None,) * 6


def fused_rhs(h, xc, p: RhsParams, alpha_1, sigma_1, alpha_2,
              scale_nominal: bool = False, qp_iters: int = 30):
    """One RHS evaluation: h (B, n), xc (B, mlp) -> (B, n).

    A CPU tensor takes ``rhs_reference``; a CUDA tensor launches K1
    (counted as ``k1.launches``, ``utils/tracing.py``) or raises.  Its
    backward on CUDA is ``fused_rhs_vjp`` (kernel K2).
    """
    if h.device.type == "cpu":
        return rhs_reference(h, xc, p, alpha_1, sigma_1, alpha_2,
                             scale_nominal, qp_iters)
    if h.device.type != "cuda":
        raise ValueError(f"fused_rhs: unsupported device {h.device}")
    return _FusedRhsCuda.apply(h, xc, *p, getattr(p, "packed", None), alpha_1,
                               sigma_1, alpha_2, scale_nominal, qp_iters)

