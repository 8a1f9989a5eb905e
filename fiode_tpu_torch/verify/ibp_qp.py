"""Interval propagation through the barrier projection QP and the
scale-nominal sigmoid, plus the worst-case Vdot of the margin candidate
(counterpart of ``fiode_tpu/verify/ibp_qp.py``).

  * ``ibp_sigmoid``: bounds of (upper - lower) sigmoid(f) + lower over the
    cell box, by the monotonicity of both factors;
  * ``ibp_cbf_qp``: per-coordinate worst-case bounds of the projected
    dynamics.  For coordinate i the adversarial box corner swaps the i-th
    diagonal (h_i at its far end, the other coordinates at the end that
    pushes the budget against coordinate i), then one QP per (cell, i): the
    n QPs of a cell are rows of one batched (N n)-row projection;
  * ``worst_case_vdot``: -f_y^lb + the max over the runner-up set of f^ub,
    the runner-up set widened by 2 eps.

The QP is a fixed-iteration bisection in plain elementwise PyTorch
operations (``ops/simplex_qp.py``); ``method`` picks the cone projection's
dual search and is an argument, ``bisect`` by default.
"""
from __future__ import annotations

import torch

from ..ops.simplex_qp import simplex_box_project, simplex_cone_project
from .crown import Eps, _is_scalar

__all__ = ["ibp_sigmoid", "ibp_cbf_qp", "ibp_cbf_qp_band",
           "ibp_cbf_qp_individual", "worst_case_vdot"]


def ibp_sigmoid(f_lb, f_ub, h_lb, h_ub, alpha_1, sigma_1, alpha_2):
    """Bounds of (upper(h) - lower(h)) sigmoid(f) + lower(h).

    upper - lower is positive and decreasing in h; lower is decreasing in h;
    the sigmoid is increasing in f.
    """
    lower_lb = -alpha_1 * (torch.exp(sigma_1 * h_ub) - 1.0)
    lower_ub = -alpha_1 * (torch.exp(sigma_1 * h_lb) - 1.0)
    out_lb = (alpha_2 * (1.0 - h_ub) - lower_lb) * torch.sigmoid(f_lb) + lower_lb
    out_ub = (alpha_2 * (1.0 - h_lb) - lower_ub) * torch.sigmoid(f_ub) + lower_ub
    return out_lb, out_ub


def ibp_cbf_qp_band(h_lb, h_ub, lb, ub, alpha_1, sigma_1, alpha_2, *,
                    with_upper: bool = False, qp_iters: int = 30,
                    method: str = "bisect"):
    """Worst-case per-coordinate bounds of QP(lower(h'), f~') over an
    explicit box [h_lb, h_ub].

    Args:
      h_lb/h_ub: (N, n) per-cell state box.
      lb/ub: (N, n) bounds of the raw dynamics f~ over the box (from CROWN).
      with_upper: also constrain with the upper barrier; this branch uses
        the linear lower barrier -alpha_1 h (the two-sided QP belongs to
        the linear-barrier dynamics variant) and always bisects.
      method: dual search of the cone projection (``ops/simplex_qp.py``).

    Returns (f_lb, f_ub), each (N, n): bounds of the projected dynamics.
    """
    N, n = h_lb.shape
    eye = torch.eye(n, dtype=torch.bool, device=h_lb.device)[None]

    # (N, n, n): row i = the box corner adversarial for coordinate i
    h_minus = h_lb[:, None, :]
    h_plus = h_ub[:, None, :]
    # for f_i's lower bound: h_j at the low end except h_i at the high end
    h_for_lb = torch.where(eye, h_plus, h_minus)
    # for f_i's upper bound: h_j at the high end except h_i at the low end
    h_for_ub = torch.where(eye, h_minus, h_plus)

    if with_upper:
        lower_lb = -alpha_1 * h_for_lb
        lower_ub = -alpha_1 * h_for_ub
    else:
        lower_lb = -alpha_1 * (torch.exp(sigma_1 * h_for_lb) - 1.0)
        lower_ub = -alpha_1 * (torch.exp(sigma_1 * h_for_ub) - 1.0)

    # nominal: for f_i's lower bound, f~_i at its lb and the others at ub
    # (pushing the shared budget away from i); vice versa for the upper bound
    f_for_lb = torch.where(eye, lb[:, None, :], ub[:, None, :])
    f_for_ub = torch.where(eye, ub[:, None, :], lb[:, None, :])

    def flat(a):
        return a.reshape(N * n, n)

    if with_upper:
        upper_lb = alpha_2 * (1.0 - h_for_lb)
        upper_ub = alpha_2 * (1.0 - h_for_ub)
        v_lb = simplex_box_project(flat(lower_lb), flat(upper_lb),
                                   flat(f_for_lb), qp_iters)
        v_ub = simplex_box_project(flat(lower_ub), flat(upper_ub),
                                   flat(f_for_ub), qp_iters)
    else:
        v_lb = simplex_cone_project(flat(lower_lb), flat(f_for_lb), qp_iters,
                                    method)
        v_ub = simplex_cone_project(flat(lower_ub), flat(f_for_ub), qp_iters,
                                    method)

    f_lb = v_lb.reshape(N, n, n).diagonal(dim1=1, dim2=2)
    f_ub = v_ub.reshape(N, n, n).diagonal(dim1=1, dim2=2)
    return f_lb, f_ub


def ibp_cbf_qp(h, eps: Eps, lb, ub, alpha_1, sigma_1, alpha_2, *,
               with_upper: bool = False, qp_iters: int = 30,
               method: str = "bisect"):
    """Worst-case per-coordinate bounds of QP(lower(h'), f~') over the
    centre +- eps box: the band form with h +- eps."""
    return ibp_cbf_qp_band(h - eps, h + eps, lb, ub, alpha_1, sigma_1,
                           alpha_2, with_upper=with_upper, qp_iters=qp_iters,
                           method=method)


def ibp_cbf_qp_individual(h, eps: Eps, lb, ub, alpha_1, sigma_1, alpha_2,
                          qp_iters: int = 30):
    """Two-sided linear-barrier variant: the barrier pair
    lower = -alpha_1 h', upper = alpha_2 (1 - h') and the two-sided solver,
    one (N n)-row solve.  ``sigma_1`` is accepted for signature symmetry and
    unused (linear barrier)."""
    del sigma_1
    return ibp_cbf_qp_band(h - eps, h + eps, lb, ub, alpha_1, 0.0, alpha_2,
                           with_upper=True, qp_iters=qp_iters)


def worst_case_vdot(eta, eps: Eps, f_lb, f_ub, label):
    """Upper bound of Vdot for V = 1 + max_wrong - p_y over the cell.

    Runner-up set: every wrong coordinate that could be the argmax somewhere
    in the box, eta_j + eps_j >= max_wrong_k (eta_k - eps_k).  With the
    uniform scalar eps this is kept in the form eta_j >= max_wrong - 2 eps,
    so that scalar-eps certificates compare with the committed ones; a
    per-dim (N, n) eps uses the general form.
    Vdot_ub = -f_label^lb + max_{runner-up} f^ub.

    ``label``: an int, or an integer tensor broadcastable to eta's leading
    axes.
    """
    n = eta.shape[-1]
    label = torch.as_tensor(label, device=eta.device)
    onehot = label[..., None] == torch.arange(n, device=eta.device)
    neg_inf = float("-inf")
    if _is_scalar(eps):
        wrong = torch.where(onehot, neg_inf, eta)
        max_wrong = wrong.amax(-1, keepdim=True)
        runner_up = (eta >= max_wrong - 2.0 * eps) & ~onehot
    else:
        wrong_lo = torch.where(onehot, neg_inf, eta - eps)
        max_lo = wrong_lo.amax(-1, keepdim=True)
        runner_up = (eta + eps >= max_lo) & ~onehot
    f_y_lb = torch.where(onehot, f_lb, 0.0).sum(-1)
    f_wrong_ub = torch.where(runner_up, f_ub, neg_inf).amax(-1)
    return -f_y_lb + f_wrong_ub
