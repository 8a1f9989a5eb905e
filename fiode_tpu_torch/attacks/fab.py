"""FAB-T, the targeted Fast Adaptive Boundary attack (counterpart of
``fiode_tpu/attacks/fab.py``).

Croce & Hein 2020 ("Minimally distorted adversarial examples with a fast
adaptive boundary attack"), targeted variant: for target class t, iterate

  1. linearise the margin m(z) = f_t(z) - f_y(z) at x_i;
  2. project x_i and the original x onto the halfspace m + <dm, z - x_i> >= 0
     in the chosen norm, clipped to the [0, 1] box (hyperplane projection
     then box clipping, the JAX package's documented approximation of the
     exact box-constrained projection);
  3. convex-combine the two projections with the adaptive weight alpha and
     take the extrapolated step (eta = 1.05);
  4. if x_i is adversarial, bias the next iterate toward x (beta = 0.9);
     track the closest adversarial found.

FAB draws no random numbers: the same inputs give the same result.
"""
from __future__ import annotations

from typing import Callable

import torch

from .apgd import target_classes

__all__ = ["fab_targeted"]


def _bshape(x):
    return (x.shape[0],) + (1,) * (x.ndim - 1)


def _norms(d, norm):
    flat = d.reshape(d.shape[0], -1)
    if norm == "Linf":
        return flat.abs().amax(-1)
    return torch.linalg.norm(flat, dim=-1)


def _project_hyperplane(z, g, b, norm):
    """Project z onto {v : <g, v> + b = 0} in the given norm (the caller
    clips to the box).  L2: closed form; Linf: a sign-direction step."""
    B = z.shape[0]
    viol = (g * z).reshape(B, -1).sum(-1) + b
    if norm == "L2":
        denom = (g * g).reshape(B, -1).sum(-1)
        t = viol / torch.clamp_min(denom, 1e-12)
        return z - t.reshape(_bshape(z)) * g
    denom = g.reshape(B, -1).abs().sum(-1)  # ||g||_1
    t = viol / torch.clamp_min(denom, 1e-12)
    return z - t.reshape(_bshape(z)) * torch.sign(g)


def fab_targeted(logits_fn: Callable, x: torch.Tensor, y: torch.Tensor, *,
                 eps: float, norm: str = "L2", n_iter: int = 100,
                 n_target_classes: int = 9, alpha_max: float = 0.1,
                 eta: float = 1.05, beta: float = 0.9):
    """Returns (x_adv, success): minimal-distortion adversarials within
    eps."""
    B = x.shape[0]
    bshape = _bshape(x)
    x = x.detach()
    rows = torch.arange(B, device=x.device)
    with torch.no_grad():
        logits0 = logits_fn(x)
    success = torch.argmax(logits0, -1) != y
    best_adv = x
    best_dist = torch.where(success, 0.0, torch.inf)

    def margin(lg, y_t):
        return lg[rows, y_t] - lg[rows, y]

    for y_t in target_classes(logits0, y, n_target_classes):
        xi = x
        for _ in range(n_iter):
            # margins and their gradients from one forward
            xg = xi.detach().requires_grad_()
            with torch.enable_grad():
                mvals = margin(logits_fn(xg), y_t)
                (g,) = torch.autograd.grad(mvals.sum(), xg)
            mvals = mvals.detach()
            b = mvals - (g * xi).reshape(B, -1).sum(-1)
            # projections of xi and x onto the target hyperplane
            p_i = torch.clamp(_project_hyperplane(xi, -g, -b, norm), 0, 1)
            p_0 = torch.clamp(_project_hyperplane(x, -g, -b, norm), 0, 1)
            d_i = _norms(p_i - xi, norm)
            d_0 = _norms(p_0 - x, norm)
            alpha = torch.clamp(d_i / torch.clamp_min(d_i + d_0, 1e-12),
                                0.0, alpha_max).reshape(bshape)
            x_new = torch.clamp(
                (1 - alpha) * (xi + eta * (p_i - xi))
                + alpha * (x + eta * (p_0 - x)), 0, 1)
            with torch.no_grad():
                adv_now = margin(logits_fn(x_new), y_t) > 0
            dist_now = _norms(x_new - x, norm)
            improved = adv_now & (dist_now < best_dist) & (dist_now <= eps)
            best_adv = torch.where(improved.reshape(bshape), x_new, best_adv)
            best_dist = torch.where(improved, dist_now, best_dist)
            # backward step toward the original when adversarial
            xi = torch.where(adv_now.reshape(bshape),
                             beta * x_new + (1 - beta) * x, x_new)
    return best_adv, best_dist <= eps
