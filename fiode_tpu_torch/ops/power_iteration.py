"""Spectral-norm estimation by power iteration, dense and convolutional
(counterpart of ``fiode_tpu/ops/power_iteration.py``).

Each call returns ``(sigma, u_new)``: the sigma_max estimate and the
warm-started singular vector, which the caller carries from step to step.
Without a vector the iteration starts from ``_start``'s fixed draw.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch.nn import functional as F

__all__ = ["power_iteration_dense", "power_iteration_conv", "conv_sigma_max"]

_EPS = 1e-12


def _normalize(v):
    return v / (torch.linalg.norm(v) + _EPS)


def _start(shape, dtype, device) -> torch.Tensor:
    """The start vector when the caller gives none: a standard normal draw
    from a generator seeded 0 (the JAX package draws from PRNGKey(0))."""
    g = torch.Generator(device).manual_seed(0)
    return torch.randn(shape, generator=g, dtype=dtype, device=device)


def power_iteration_dense(A: torch.Tensor, u: Optional[torch.Tensor] = None,
                          num_iter: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """sigma_max of an (m, n) matrix from the left vector u (m,)."""
    if u is None:
        u = _start((A.shape[0],), A.dtype, A.device)
    u = _normalize(u)
    for _ in range(num_iter):
        v = _normalize(A.T @ u)
        u = _normalize(A @ v)
    v = _normalize(A.T @ u)
    return u @ (A @ v), u


def power_iteration_conv(weight: torch.Tensor, input_shape: Sequence[int],
                         u: Optional[torch.Tensor] = None, num_iter: int = 1,
                         stride: int = 1, padding: int = 0
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """sigma_max of a conv2d (co, ci, k, k) as a linear map on one
    (ci, h, w) input; u (1, ci, h, w) lives on the input side.  The
    transposed map is the conv's exact adjoint, its VJP."""
    def fwd(x):
        return F.conv2d(x, weight, None, stride, padding)

    if u is None:
        u = _start((1, *input_shape), weight.dtype, weight.device)
    u = _normalize(u)
    for _ in range(num_iter):
        v = _normalize(fwd(u))
        _, vjp = torch.func.vjp(fwd, u)
        u = _normalize(vjp(v)[0])
    v = _normalize(fwd(u))
    return torch.sum(v * fwd(u)), u


def conv_sigma_max(weight: torch.Tensor, input_shape: Sequence[int],
                   stride: int = 1, padding: int = 0,
                   num_iter: int = 50) -> torch.Tensor:
    """sigma_max of a conv layer after ``num_iter`` iterations from the
    fixed start (for tests and certification)."""
    sigma, _ = power_iteration_conv(weight, input_shape, num_iter=num_iter,
                                    stride=stride, padding=padding)
    return sigma
