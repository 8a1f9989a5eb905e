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
A shape whose weights and tile scratch exceed a block's shared memory is
refused with a ``ValueError`` before the launch.  The state keeps its true
width n: the TPU's 128-lane padding is not carried over.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from ._build import load_library
from .simplex_qp import cone_project_mu, simplex_cone_project

__all__ = ["RhsParams", "pack_rhs_params", "rhs_reference",
           "rhs_vjp_reference", "fused_rhs", "fused_rhs_vjp"]


class RhsParams(NamedTuple):
    W1: torch.Tensor  # (mlp, n)
    W2: torch.Tensor  # (mlp, mlp)
    W3: torch.Tensor  # (n, mlp)
    b2: torch.Tensor  # (mlp,)
    b3: torch.Tensor  # (n,)


def pack_rhs_params(W1, W2, W3, b2, b3) -> RhsParams:
    """Dense dynamics weights as contiguous float32 tensors."""
    return RhsParams(*(t.to(torch.float32).contiguous()
                       for t in (W1, W2, W3, b2, b3)))


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
def _lib():
    lib = load_library("fused_rhs")
    fn = lib.fused_rhs_forward
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 3
                   + [ctypes.c_float] * 3 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    fn = lib.fused_rhs_backward
    fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 4
                   + [ctypes.c_float] * 3 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.fused_rhs_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.fused_rhs_smem_bytes.restype = ctypes.c_longlong
    lib.fused_rhs_smem_limit.argtypes = []
    lib.fused_rhs_smem_limit.restype = ctypes.c_longlong
    lib.fused_rhs_grad_floats.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.fused_rhs_grad_floats.restype = ctypes.c_int
    lib.fused_rhs_error_string.argtypes = [ctypes.c_int]
    lib.fused_rhs_error_string.restype = ctypes.c_char_p
    return lib


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


def _check_smem(lib, name, n, m, backward):
    """Refuse, before the launch, a shape whose weights and tile scratch do
    not fit in one block's shared memory."""
    need = lib.fused_rhs_smem_bytes(n, m, int(backward))
    limit = lib.fused_rhs_smem_limit()
    if need > limit:
        raise ValueError(
            f"{name}: n = {n}, mlp = {m} needs {need} bytes of shared memory "
            f"per block for the weights and the tile scratch, more than the "
            f"{limit} a block can have"
        )


def _want(h, xc, p: RhsParams):
    B, n = h.shape
    m = p.W2.shape[0]
    return {"h": (h, (B, n)), "xc": (xc, (B, m)), "W1": (p.W1, (m, n)),
            "W2": (p.W2, (m, m)), "W3": (p.W3, (n, m)), "b2": (p.b2, (m,)),
            "b3": (p.b3, (n,))}


def _raise_on(lib, rc, what):
    if rc != 0:
        msg = lib.fused_rhs_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel failed: {msg}")


def _launch(h, xc, p: RhsParams, alpha_1, sigma_1, alpha_2, scale_nominal,
            qp_iters):
    _check("fused_rhs", h, _want(h, xc, p))
    B, n = h.shape
    m = p.W2.shape[0]
    lib = _lib()
    _check_smem(lib, "fused_rhs", n, m, False)
    out = torch.empty_like(h)
    rc = lib.fused_rhs_forward(
        h.data_ptr(), xc.data_ptr(), p.W1.data_ptr(), p.W2.data_ptr(),
        p.W3.data_ptr(), p.b2.data_ptr(), p.b3.data_ptr(), out.data_ptr(),
        B, n, m, float(alpha_1), float(sigma_1), float(alpha_2),
        int(bool(scale_nominal)), int(qp_iters),
        torch.cuda.current_stream(h.device).cuda_stream,
    )
    _raise_on(lib, rc, "fused_rhs")
    fused_rhs.launches += 1
    return out


def _launch_vjp(h, xc, g, p: RhsParams, alpha_1, sigma_1, alpha_2,
                scale_nominal, qp_iters, weight_grads):
    want = _want(h, xc, p)
    want["g"] = (g, tuple(h.shape))
    _check("fused_rhs_vjp", h, want)
    B, n = h.shape
    m = p.W2.shape[0]
    lib = _lib()
    _check_smem(lib, "fused_rhs_vjp", n, m, True)
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
        h.data_ptr(), xc.data_ptr(), g.data_ptr(), p.W1.data_ptr(),
        p.W2.data_ptr(), p.W3.data_ptr(), p.b2.data_ptr(), p.b3.data_ptr(),
        dh.data_ptr(), dxc.data_ptr(),
        None if dw is None else dw.data_ptr(),
        None if ws is None else ws.data_ptr(), slots, B, n, m,
        float(alpha_1), float(sigma_1), float(alpha_2),
        int(bool(scale_nominal)), int(qp_iters),
        torch.cuda.current_stream(h.device).cuda_stream,
    )
    _raise_on(lib, rc, "fused_rhs_vjp")
    fused_rhs_vjp.launches += 1
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
    (and adds one to ``fused_rhs_vjp.launches``) or raises.  Without weight
    gradients K2 skips their per-block partial sums and the reduction.
    """
    if h.device.type == "cpu":
        dh, dxc, dp = rhs_vjp_reference(h, xc, g, p, alpha_1, sigma_1,
                                        alpha_2, scale_nominal, qp_iters)
        return dh, dxc, dp if weight_grads else None
    if h.device.type != "cuda":
        raise ValueError(f"fused_rhs_vjp: unsupported device {h.device}")
    return _launch_vjp(h, xc, g, p, alpha_1, sigma_1, alpha_2, scale_nominal,
                       qp_iters, weight_grads)


fused_rhs_vjp.launches = 0


class _FusedRhsCuda(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, xc, W1, W2, W3, b2, b3, alpha_1, sigma_1, alpha_2,
                scale_nominal, qp_iters):
        ctx.save_for_backward(h, xc, W1, W2, W3, b2, b3)
        ctx.consts = (alpha_1, sigma_1, alpha_2, scale_nominal, qp_iters)
        return _launch(h, xc, RhsParams(W1, W2, W3, b2, b3), alpha_1,
                       sigma_1, alpha_2, scale_nominal, qp_iters)

    @staticmethod
    def backward(ctx, g):
        h, xc, *w = ctx.saved_tensors
        weight_grads = any(ctx.needs_input_grad[2:7])
        dh, dxc, dp = fused_rhs_vjp(h, xc, g.contiguous(), RhsParams(*w),
                                    *ctx.consts, weight_grads)
        dw = tuple(dp) if dp is not None else (None,) * 5
        return (dh, dxc, *dw) + (None,) * 5


def fused_rhs(h, xc, p: RhsParams, alpha_1, sigma_1, alpha_2,
              scale_nominal: bool = False, qp_iters: int = 30):
    """One RHS evaluation: h (B, n), xc (B, mlp) -> (B, n).

    A CPU tensor takes ``rhs_reference``; a CUDA tensor launches K1 (and
    adds one to ``fused_rhs.launches``) or raises.  Its backward on CUDA
    is ``fused_rhs_vjp`` (kernel K2).
    """
    if h.device.type == "cpu":
        return rhs_reference(h, xc, p, alpha_1, sigma_1, alpha_2,
                             scale_nominal, qp_iters)
    if h.device.type != "cuda":
        raise ValueError(f"fused_rhs: unsupported device {h.device}")
    return _FusedRhsCuda.apply(h, xc, *p, alpha_1, sigma_1, alpha_2,
                               scale_nominal, qp_iters)


fused_rhs.launches = 0
