"""Plain reference of a CROWN certification block: CROWN bounds of the ReLU
dynamics twin over each grid cell's box, interval propagation through the
barrier QP, the worst-case Vdot of the margin candidate, and the
decision-boundary grid's membership rule and size.

Frozen copies, at commit 08631d7, of ``fiode_tpu_torch/verify/crown.py``
(``relu_relaxation``, ``_concretise``, ``_backward_from``,
``crown_mlp_bounds`` for a scalar cell radius, no alpha-CROWN),
``fiode_tpu_torch/verify/ibp_qp.py`` (``ibp_cbf_qp_band`` without the
upper barrier, ``worst_case_vdot`` for a scalar radius),
``fiode_tpu_torch/verify/certify.py`` (``label_perms``, ``swap_columns``,
the loop of ``Certifier.crown_block``) and the counting oracle of
``fiode_tpu_torch/verify/grid.py``.  Imports nothing of the program.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .model import cone_project

__all__ = ["crown_bounds", "qp_bounds", "worst_vdot", "block_worst",
           "label_perms", "grid_count", "grid_faults", "kappa"]


def _relax(l, u):
    unstable = (l < 0) & (u > 0)
    on = (l >= 0).to(l.dtype)
    denom = torch.where(unstable, u - l, 1.0)
    return (torch.where(unstable, u / denom, on),
            torch.where(unstable, -u * l / denom, 0.0),
            torch.where(unstable, (u >= -l).to(l.dtype), on),
            torch.zeros_like(l))


def _concretise(Lu_t, Ll_t, cu, cl, eta0, eps):
    ub = torch.einsum("nko,nk->no", Lu_t, eta0) + cu + eps * Lu_t.abs().sum(1)
    lb = torch.einsum("nko,nk->no", Ll_t, eta0) + cl - eps * Ll_t.abs().sum(1)
    return lb, ub


def _backward_from(layer, Ws, bs, relax, eta0, eps, x_bias):
    W, b = Ws[layer - 1], bs[layer - 1]
    N, out_dim = eta0.shape[0], W.shape[0]
    if layer == 1:
        center = eta0 @ W.T + b + x_bias
        radius = eps * W.abs().sum(-1)
        return center - radius, center + radius
    if layer == 2 and out_dim >= Ws[0].shape[1]:
        a_up, b_up, a_lo, b_lo = relax[0]
        b1_row = bs[0] + x_bias
        W_abs = W.abs()
        u_vec = a_up * b1_row + b_up
        l_vec = a_lo * b1_row + b_lo
        s = (u_vec + l_vec) @ W.T
        d = (u_vec - l_vec) @ W_abs.T
        W1t = Ws[0].T
        S = ((a_up + a_lo)[:, None, :] * W1t[None]) @ W.T
        D = ((a_up - a_lo)[:, None, :] * W1t[None]) @ W_abs.T
        return _concretise(0.5 * (S + D), 0.5 * (S - D), b + 0.5 * (s + d),
                           b + 0.5 * (s - d), eta0, eps)
    Lu = W.expand(N, *W.shape)
    Ll = Lu
    cu = b.expand(N, out_dim)
    cl = cu
    for j in range(layer - 1, 0, -1):
        a_up, b_up, a_lo, b_lo = relax[j - 1]
        Lu_pos, Lu_neg = Lu.clamp_min(0.0), Lu.clamp_max(0.0)
        cu = (cu + torch.einsum("noi,ni->no", Lu_pos, b_up)
              + torch.einsum("noi,ni->no", Lu_neg, b_lo))
        Lu = Lu_pos * a_up[:, None, :] + Lu_neg * a_lo[:, None, :]
        Ll_pos, Ll_neg = Ll.clamp_min(0.0), Ll.clamp_max(0.0)
        cl = (cl + torch.einsum("noi,ni->no", Ll_pos, b_lo)
              + torch.einsum("noi,ni->no", Ll_neg, b_up))
        Ll = Ll_pos * a_lo[:, None, :] + Ll_neg * a_up[:, None, :]
        bj = bs[j - 1] + x_bias if j == 1 else bs[j - 1]
        bj = bj.expand(N, bj.shape[-1])
        cu = cu + torch.einsum("noi,ni->no", Lu, bj)
        cl = cl + torch.einsum("noi,ni->no", Ll, bj)
        Lu, Ll = Lu @ Ws[j - 1], Ll @ Ws[j - 1]
    return _concretise(Lu.transpose(1, 2), Ll.transpose(1, 2), cu, cl, eta0,
                       eps)


def crown_bounds(Ws, bs, eta0, eps: float, x_bias):
    """Elementwise (lb, ub) (N, out) of W3 relu(W2 relu(W1 eta + x_bias +
    b1) + b2) + b3 over the Linf box of radius eps around each row eta0."""
    relax = []
    for j in range(1, len(Ws)):
        relax.append(_relax(*_backward_from(j, Ws, bs, relax, eta0, eps,
                                            x_bias)))
    return _backward_from(len(Ws), Ws, bs, relax, eta0, eps, x_bias)


def qp_bounds(h, eps: float, lb, ub, cfg: dict):
    """Per-coordinate bounds of the projected dynamics over the box: for
    coordinate i, the box corner adversarial to it and one cone projection
    per (cell, i)."""
    a1, s1 = cfg["alpha_1"], cfg["sigma_1"]
    N, n = h.shape
    eye = torch.eye(n, dtype=torch.bool, device=h.device)[None]
    h_minus, h_plus = (h - eps)[:, None, :], (h + eps)[:, None, :]
    lower_lb = -a1 * (torch.exp(s1 * torch.where(eye, h_plus, h_minus)) - 1.0)
    lower_ub = -a1 * (torch.exp(s1 * torch.where(eye, h_minus, h_plus)) - 1.0)
    f_for_lb = torch.where(eye, lb[:, None, :], ub[:, None, :])
    f_for_ub = torch.where(eye, ub[:, None, :], lb[:, None, :])
    it = cfg["qp_iters"]
    v_lb = cone_project(lower_lb.reshape(N * n, n), f_for_lb.reshape(N * n, n), it)
    v_ub = cone_project(lower_ub.reshape(N * n, n), f_for_ub.reshape(N * n, n), it)
    return (v_lb.reshape(N, n, n).diagonal(dim1=1, dim2=2),
            v_ub.reshape(N, n, n).diagonal(dim1=1, dim2=2))


def worst_vdot(eta, eps: float, f_lb, f_ub, label):
    """-f_label^lb + the max of f^ub over the runner-up set (every wrong
    coordinate within 2 eps of the largest wrong one)."""
    n = eta.shape[-1]
    onehot = label[..., None] == torch.arange(n, device=eta.device)
    wrong = torch.where(onehot, float("-inf"), eta)
    runner_up = (eta >= wrong.amax(-1, keepdim=True) - 2.0 * eps) & ~onehot
    return (-torch.where(onehot, f_lb, 0.0).sum(-1)
            + torch.where(runner_up, f_ub, float("-inf")).amax(-1))


def label_perms(labels, n: int):
    """(I, n) permutations swapping column 0 with each image's label."""
    I = labels.shape[0]
    perms = torch.arange(n, device=labels.device).repeat(I, 1)
    rows = torch.arange(I, device=labels.device)
    perms[rows, 0] = labels
    perms[rows, labels] = 0
    return perms


def block_worst(Ws, bs, x_biases, labels, etas, valids, eps: float,
                kappa: float, cfg: dict):
    """Each image's worst Vdot bound + kappa over a block: x_biases (I, m),
    labels (I,), etas (K, C, n) cells with coordinate 0 the label's,
    valids (K, C).  Returns (I,)."""
    I, (K, C, n) = labels.shape[0], etas.shape
    perms = label_perms(labels, n)
    x_rows = x_biases[:, None, :].expand(I, C, -1).reshape(I * C, -1)
    label_rows = labels[:, None].expand(I, C).reshape(I * C)
    worst = torch.full((I,), float("-inf"), device=etas.device)
    for k in range(K):
        eta = etas[k].expand(I, C, n).gather(
            2, perms[:, None, :].expand(I, C, n)).reshape(I * C, n)
        lb, ub = crown_bounds(Ws, bs, eta, eps, x_rows)
        f_lb, f_ub = qp_bounds(eta, eps, lb, ub, cfg)
        v = worst_vdot(eta, eps, f_lb, f_ub, label_rows).view(I, C)
        v = torch.where(valids[k], v, float("-inf"))
        worst = torch.maximum(worst, v.amax(1) + kappa)
    return worst


@functools.lru_cache(maxsize=None)
def grid_count(n: int, T: int) -> int:
    """Lattice points of (Z / T)^n on the simplex whose coordinate 0 ties
    the largest of the others."""

    @functools.lru_cache(maxsize=None)
    def comps_le(k, s, m):
        if s < 0 or m * k < s:
            return 0
        if k == 0:
            return 1 if s == 0 else 0
        return sum(comps_le(k - 1, s - v, m) for v in range(min(m, s) + 1))

    return sum(comps_le(n - 1, T - m, m) - (comps_le(n - 1, T - m, m - 1)
                                             if m > 0 else 0)
               for m in range(T + 1))


def grid_faults(rows: np.ndarray, T: int, device="cpu",
                block: int = 1 << 22) -> int:
    """How far float32 rows (count, n) are from the whole decision-boundary
    grid in its order: rows that are not points of the lattice (k / T to
    float32 round-off, whole k >= 0 summing to T, k_0 equal to the largest
    other k),
    rows not after the row before them in lexicographic order (coordinate 0
    first), and the difference of the row count from ``grid_count``.  Zero
    only for every point of the grid, each once, in order.  Computed on
    ``device``, ``block`` rows at a time."""
    n = rows.shape[1]
    powers = torch.tensor([(T + 1) ** (n - 1 - j) for j in range(n)],
                          dtype=torch.int64, device=device)
    faults, last = abs(len(rows) - grid_count(n, T)), -1
    for i in range(0, len(rows), block):
        r = torch.from_numpy(np.ascontiguousarray(rows[i:i + block])).to(device)
        rT = r.double() * T
        kf = torch.round(rT)
        exact = (rT - kf).abs() <= 1e-4
        k = kf.long()
        ok = (exact.all(1) & (k >= 0).all(1) & (k.sum(1) == T)
              & (k[:, 0] == k[:, 1:].amax(1)))
        key = (k * powers).sum(1)
        faults += int((~ok).sum()) + int((key[1:] <= key[:-1]).sum())
        faults += int(key[0] <= last)
        last = int(key[-1])
    return faults


def kappa(cfg: dict) -> float:
    """The CROWN certificate's margin sqrt(2) eps_input / min(std)."""
    return float(math.sqrt(2.0) * cfg["eps"] / min(cfg["std"]))
