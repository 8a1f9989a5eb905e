"""Simplex-cone projection QP (counterpart of ``fiode_tpu/ops/simplex_qp.py``).

Per batch row, projects ``nominal`` onto {v : sum(v) = 0, v >= lower}:
``v(mu) = max(nominal - mu, lower)`` with the dual ``mu`` found by a
fixed-iteration bisection (the reference-matching ``bisect`` method).  The
backward pass is the closed-form active-set Jacobian, written as a
``torch.autograd.Function``.
"""
from __future__ import annotations

import torch

__all__ = ["cone_project_mu", "simplex_cone_project"]


def cone_project_mu(lower: torch.Tensor, nominal: torch.Tensor,
                    n_iter: int = 30) -> torch.Tensor:
    """Dual optimum mu of the no-upper projection, shape (..., 1) (no grad)."""
    lo = nominal.amin(-1, keepdim=True)
    hi = (nominal - lower).amax(-1, keepdim=True)
    for _ in range(n_iter):
        mid = 0.5 * (lo + hi)
        s = torch.maximum(nominal - mid, lower).sum(-1, keepdim=True)
        # s > 0: the root is above mid; s < 0: below it
        lo = torch.where(s > 0, mid, lo)
        hi = torch.where(s < 0, mid, hi)
    return 0.5 * (lo + hi)


class _ConeProject(torch.autograd.Function):
    @staticmethod
    def forward(ctx, lower, nominal, n_iter):
        mu = cone_project_mu(lower, nominal, n_iter)
        ctx.save_for_backward(mu, lower, nominal)
        return torch.maximum(nominal - mu, lower)

    @staticmethod
    def backward(ctx, g):
        mu, lower, nominal = ctx.saved_tensors
        # active set = the branch the clamp took (see the JAX _cone_bwd for
        # why not the sign of the KKT multiplier)
        lower_active = (nominal - mu) < lower
        free = ~lower_active
        n_free = free.sum(-1, keepdim=True).to(g.dtype).clamp_min(1.0)
        corr = torch.where(free, g, 0.0).sum(-1, keepdim=True) / n_free
        d_lower = torch.where(lower_active, g - corr, 0.0)
        d_nominal = torch.where(free, g - corr, 0.0)
        return d_lower, d_nominal, None


def simplex_cone_project(lower: torch.Tensor, nominal: torch.Tensor,
                         n_iter: int = 30) -> torch.Tensor:
    """Project ``nominal`` (..., n) onto {v : sum(v) = 0, v >= lower}."""
    return _ConeProject.apply(lower, nominal, n_iter)
