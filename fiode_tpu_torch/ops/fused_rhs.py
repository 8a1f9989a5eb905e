"""Fused ODE right-hand side (counterpart of ``fiode_tpu/ops/fused_rhs.py``).

``fused_rhs`` evaluates the projected simplex dynamics on densified weights:

    z1 = relu(h W1^T + xc);  z2 = relu(z1 W2^T + b2);  f = z2 W3^T + b3
    lower = -alpha_1 (exp(sigma_1 h) - 1)
    [scale_nominal]  f = (alpha_2 (1 - h) - lower) sigmoid(f) + lower
    out = simplex_cone_project(lower, f)

with ``xc = U x_feat + bU + b1`` computed once per solve.  The activation is
ReLU and there is no dropout: the caller rejects any other configuration.

On a CPU tensor it runs ``rhs_reference`` (plain PyTorch, differentiable).
On a CUDA tensor it launches kernel K1 (``csrc/fused_rhs.cu``), which has
no backward kernel yet.  The state keeps its true width n: the TPU's
128-lane padding is not carried over.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ._build import load_library
from .simplex_qp import simplex_cone_project

__all__ = ["RhsParams", "pack_rhs_params", "rhs_reference", "fused_rhs"]


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


@functools.cache
def _lib():
    lib = load_library("fused_rhs")
    fn = lib.fused_rhs_forward
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 3
                   + [ctypes.c_float] * 3 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.fused_rhs_error_string.argtypes = [ctypes.c_int]
    lib.fused_rhs_error_string.restype = ctypes.c_char_p
    return lib


def _launch(h, xc, p: RhsParams, alpha_1, sigma_1, alpha_2, scale_nominal,
            qp_iters):
    B, n = h.shape
    m = p.W2.shape[0]
    want = {"h": (h, (B, n)), "xc": (xc, (B, m)), "W1": (p.W1, (m, n)),
            "W2": (p.W2, (m, m)), "W3": (p.W3, (n, m)), "b2": (p.b2, (m,)),
            "b3": (p.b3, (n,))}
    for name, (t, shape) in want.items():
        if (t.device != h.device or t.dtype != torch.float32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(
                f"fused_rhs: {name} must be a contiguous float32 {shape} "
                f"tensor on {h.device}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}"
            )
    out = torch.empty_like(h)
    lib = _lib()
    rc = lib.fused_rhs_forward(
        h.data_ptr(), xc.data_ptr(), p.W1.data_ptr(), p.W2.data_ptr(),
        p.W3.data_ptr(), p.b2.data_ptr(), p.b3.data_ptr(), out.data_ptr(),
        B, n, m, float(alpha_1), float(sigma_1), float(alpha_2),
        int(bool(scale_nominal)), int(qp_iters),
        torch.cuda.current_stream(h.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"fused_rhs kernel failed: {lib.fused_rhs_error_string(rc).decode()}"
        )
    fused_rhs.launches += 1
    return out


class _FusedRhsCuda(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, xc, W1, W2, W3, b2, b3, alpha_1, sigma_1, alpha_2,
                scale_nominal, qp_iters):
        return _launch(h, xc, RhsParams(W1, W2, W3, b2, b3), alpha_1,
                       sigma_1, alpha_2, scale_nominal, qp_iters)

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(
            "fused_rhs on CUDA has no backward kernel yet: the fused RHS "
            "backward (K2) arrives with gradients through the solve (Slice C)"
        )


def fused_rhs(h, xc, p: RhsParams, alpha_1, sigma_1, alpha_2,
              scale_nominal: bool = False, qp_iters: int = 30):
    """One RHS evaluation: h (B, n), xc (B, mlp) -> (B, n).

    A CPU tensor takes ``rhs_reference``; a CUDA tensor launches K1 (and
    adds one to ``fused_rhs.launches``) or raises.
    """
    if h.device.type == "cpu":
        return rhs_reference(h, xc, p, alpha_1, sigma_1, alpha_2,
                             scale_nominal, qp_iters)
    if h.device.type != "cuda":
        raise ValueError(f"fused_rhs: unsupported device {h.device}")
    return _FusedRhsCuda.apply(h, xc, *p, alpha_1, sigma_1, alpha_2,
                               scale_nominal, qp_iters)


fused_rhs.launches = 0
