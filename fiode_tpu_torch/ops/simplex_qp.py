"""Simplex projection QPs (counterpart of ``fiode_tpu/ops/simplex_qp.py``).

Per batch row, projects ``nominal`` onto

    {v : sum(v) = 0, lower <= v (<= upper)}

whose KKT conditions reduce to a 1-D root-find in the dual ``mu``:
``v(mu) = clip(nominal - mu, lower, upper)`` with ``sum(v(mu)) = 0``.  The
sum is monotone non-increasing in mu, so mu is found by a fixed-iteration
bisection (``bisect``, the method every committed artifact was taken with).
For the no-upper cone projection two closed forms exist as well (``exact``:
the rank rule by pairwise rank statistics; ``sort``: the same rule by sorted
cumulative sums); they agree with the bisection within its terminal bracket
width.  The method is an argument, never read from the environment.

The backward passes are the closed-form active-set Jacobians of the
projections, written as ``torch.autograd.Function``s: O(n) per row, the
bisection is never differentiated.
"""
from __future__ import annotations

import torch

__all__ = ["cone_project_mu", "cone_project_mu_exact", "cone_project_mu_sort",
           "box_project_mu", "simplex_cone_project", "simplex_box_project",
           "QP_METHODS"]

QP_METHODS = ("bisect", "exact", "sort")


def _bisect_mu(sum_at, lo, hi, n_iter: int) -> torch.Tensor:
    """Root of the monotone-decreasing ``sum_at`` by ``n_iter`` halvings of
    the bracket [lo, hi] (``sum_at(lo) >= 0 >= sum_at(hi)``); (..., 1)."""
    for _ in range(n_iter):
        mid = 0.5 * (lo + hi)
        s = sum_at(mid)
        # s > 0: the root is above mid; s < 0: below it
        lo = torch.where(s > 0, mid, lo)
        hi = torch.where(s < 0, mid, hi)
    return 0.5 * (lo + hi)


# -- lower bound only: {v : sum(v) = 0, v >= lower} ---------------------------


def cone_project_mu(lower: torch.Tensor, nominal: torch.Tensor,
                    n_iter: int = 30) -> torch.Tensor:
    """Dual optimum mu of the no-upper projection, shape (..., 1) (no grad)."""
    lo = nominal.amin(-1, keepdim=True)
    hi = (nominal - lower).amax(-1, keepdim=True)
    return _bisect_mu(
        lambda mu: torch.maximum(nominal - mu, lower).sum(-1, keepdim=True),
        lo, hi, n_iter)


def cone_project_mu_exact(lower: torch.Tensor,
                          nominal: torch.Tensor) -> torch.Tensor:
    """Exact dual optimum of the no-upper projection (no grad).

    Water-filling in ``w = nominal - lower``: find mu with
    ``sum(max(w - mu, 0)) = s``, ``s = -sum(lower) >= 0``.  With the top-k
    elements free, ``mu_k = (sum_topk(w) - s) / k``, and the optimum takes
    the largest k with ``w_(k) > mu_k``; ranks come from a pairwise
    (..., n, n) comparison, ties broken by index."""
    w = nominal - lower
    s = -lower.sum(-1, keepdim=True)
    n = w.shape[-1]
    idx = torch.arange(n, device=w.device)
    wi, wj = w[..., :, None], w[..., None, :]
    ge = (wj > wi) | ((wj == wi) & (idx[None, :] <= idx[:, None]))
    k = ge.sum(-1).to(w.dtype)                       # rank of w_i from the top
    S = torch.where(ge, wj, 0.0).sum(-1)             # sum of the top-k values
    mu_c = (S - s) / k
    valid = w > mu_c
    k_masked = torch.where(valid, k, 0.0)
    i_star = k_masked.argmax(-1, keepdim=True)
    mu = mu_c.gather(-1, i_star)
    # none valid (s == 0, every coordinate clamped): any mu >= max(w) works
    return torch.where(valid.any(-1, keepdim=True), mu,
                       w.amax(-1, keepdim=True))


def cone_project_mu_sort(lower: torch.Tensor,
                         nominal: torch.Tensor) -> torch.Tensor:
    """Exact dual optimum by the descending sort of ``w`` and its cumulative
    sums (no grad): the valid ranks are a prefix, so k* = #valid."""
    w = nominal - lower
    s = -lower.sum(-1, keepdim=True)
    n = w.shape[-1]
    ws = w.sort(-1, descending=True).values
    cs = ws.cumsum(-1)
    k = torch.arange(1, n + 1, device=w.device, dtype=w.dtype)
    mu_k = (cs - s) / k
    valid = ws > mu_k
    k_star = valid.sum(-1, keepdim=True)
    mu = mu_k.gather(-1, (k_star - 1).clamp_min(0))
    return torch.where(k_star > 0, mu, ws[..., :1])


def _cone_mu(lower, nominal, n_iter: int, method: str) -> torch.Tensor:
    if method == "bisect":
        return cone_project_mu(lower, nominal, n_iter)
    if method == "exact":
        return cone_project_mu_exact(lower, nominal)
    if method == "sort":
        return cone_project_mu_sort(lower, nominal)
    raise ValueError(f"method must be one of {QP_METHODS}, got {method!r}")


def _free_mean(g, free):
    """Mean of g over each row's free coordinates, (..., 1)."""
    n_free = free.sum(-1, keepdim=True).to(g.dtype).clamp_min(1.0)
    return torch.where(free, g, 0.0).sum(-1, keepdim=True) / n_free


class _ConeProject(torch.autograd.Function):
    @staticmethod
    def forward(ctx, lower, nominal, n_iter, method):
        mu = _cone_mu(lower, nominal, n_iter, method)
        ctx.save_for_backward(mu, lower, nominal)
        return torch.maximum(nominal - mu, lower)

    @staticmethod
    def backward(ctx, g):
        mu, lower, nominal = ctx.saved_tensors
        # active set = the branch the clamp took (see the JAX _cone_bwd for
        # why not the sign of the KKT multiplier)
        lower_active = (nominal - mu) < lower
        free = ~lower_active
        corr = _free_mean(g, free)
        d_lower = torch.where(lower_active, g - corr, 0.0)
        d_nominal = torch.where(free, g - corr, 0.0)
        return d_lower, d_nominal, None, None


def simplex_cone_project(lower: torch.Tensor, nominal: torch.Tensor,
                         n_iter: int = 30,
                         method: str = "bisect") -> torch.Tensor:
    """Project ``nominal`` (..., n) onto {v : sum(v) = 0, v >= lower}
    (``sum(lower) <= 0`` must hold).  ``method``: "bisect" (``n_iter``
    halvings), "exact" or "sort" (closed forms; ``n_iter`` unused)."""
    return _ConeProject.apply(lower, nominal, n_iter, method)


# -- two-sided: {v : sum(v) = 0, lower <= v <= upper} -------------------------


def box_project_mu(lower: torch.Tensor, upper: torch.Tensor,
                   nominal: torch.Tensor, n_iter: int = 30) -> torch.Tensor:
    """Dual optimum mu of the two-sided projection, shape (..., 1) (no grad)."""
    lo = (nominal - upper).amin(-1, keepdim=True)
    hi = (nominal - lower).amax(-1, keepdim=True)
    return _bisect_mu(
        lambda mu: torch.clamp(nominal - mu, lower, upper).sum(-1, keepdim=True),
        lo, hi, n_iter)


class _BoxProject(torch.autograd.Function):
    @staticmethod
    def forward(ctx, lower, upper, nominal, n_iter):
        mu = box_project_mu(lower, upper, nominal, n_iter)
        ctx.save_for_backward(mu, lower, upper, nominal)
        return torch.clamp(nominal - mu, lower, upper)

    @staticmethod
    def backward(ctx, g):
        mu, lower, upper, nominal = ctx.saved_tensors
        lower_active = (nominal - mu) < lower
        upper_active = (nominal - mu) > upper
        free = ~(lower_active | upper_active)
        # Exact active-set Jacobian: with mu = (sum_F nominal + sum_L lower
        # + sum_U upper) / |F| from the budget, every active coordinate
        # pushes mu onto the free rows only, so all three blocks share the
        # mean-over-free correction, also on a row that clamps against both
        # bounds (held against central differences in the tests).
        corr = _free_mean(g, free)
        d_nominal = torch.where(free, g - corr, 0.0)
        d_lower = torch.where(lower_active, g - corr, 0.0)
        d_upper = torch.where(upper_active, g - corr, 0.0)
        return d_lower, d_upper, d_nominal, None


def simplex_box_project(lower: torch.Tensor, upper: torch.Tensor,
                        nominal: torch.Tensor, n_iter: int = 30) -> torch.Tensor:
    """Project ``nominal`` onto {v : sum(v) = 0, lower <= v <= upper}."""
    return _BoxProject.apply(lower, upper, nominal, n_iter)
