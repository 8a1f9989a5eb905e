"""Spectral-norm estimation by power iteration, dense and convolutional
(counterpart of ``fiode_tpu/ops/power_iteration.py``).

Each call returns ``(sigma, u_new)``: the sigma_max estimate and the
warm-started singular vector, which the caller carries from step to step.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch.nn import functional as F

__all__ = ["power_iteration_dense", "power_iteration_conv"]

_EPS = 1e-12


def _normalize(v):
    return v / (torch.linalg.norm(v) + _EPS)


def power_iteration_dense(A: torch.Tensor, u: torch.Tensor,
                          num_iter: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """sigma_max of an (m, n) matrix from the left vector u (m,)."""
    u = _normalize(u)
    for _ in range(num_iter):
        v = _normalize(A.T @ u)
        u = _normalize(A @ v)
    v = _normalize(A.T @ u)
    return u @ (A @ v), u


def power_iteration_conv(weight: torch.Tensor, input_shape: Sequence[int],
                         u: torch.Tensor, num_iter: int = 1, stride: int = 1,
                         padding: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """sigma_max of a conv2d (co, ci, k, k) as a linear map on one
    (ci, h, w) input; u (1, ci, h, w) lives on the input side.  The
    transposed map is the conv's exact adjoint, its VJP."""
    def fwd(x):
        return F.conv2d(x, weight, None, stride, padding)

    u = _normalize(u)
    for _ in range(num_iter):
        v = _normalize(fwd(u))
        _, vjp = torch.func.vjp(fwd, u)
        u = _normalize(vjp(v)[0])
    v = _normalize(fwd(u))
    return torch.sum(v * fwd(u)), u
