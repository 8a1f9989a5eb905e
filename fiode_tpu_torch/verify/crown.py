"""CROWN / IBP linear bound propagation for ReLU MLPs (counterpart of
``fiode_tpu/verify/crown.py``).

Bounds the 3-linear / 2-ReLU two-input dynamics twin

    f(eta, x) = W3 relu(W2 relu(W1 eta + U x + b1) + b2) + b3

under an Linf perturbation of eta with x fixed.  Everything is batched over
grid cells (leading axis N); the backward passes are ``einsum`` / ``matmul``
products on (N, ...) operands.

Algorithm (standard CROWN):
  * the first pre-activation is exact-affine in eta: centre +- eps |W1| 1;
  * deeper pre-activation bounds come from a backward pass from that layer;
  * ReLU relaxation: unstable neurons get the chord upper line
    u / (u - l) (z - l) and an adaptive lower line alpha z with
    alpha = 1[u >= |l|]; stable neurons propagate exactly;
  * concretisation over the eta box adds eps |Lambda W1| 1.

``ibp_mlp_bounds`` gives pure interval bounds (a soundness cross-check:
CROWN must be at least as tight, and both must contain sampled values).

``crown_mlp_bounds`` launches kernel K4 (``ops/fused_crown``) where its
route takes the call (CUDA float32, three layers, m2 >= n, no gradient to
carry) and runs ``crown_bounds_reference``, K4's plain version, otherwise.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple, Union

import torch

from ..ops import fused_crown

__all__ = ["crown_mlp_bounds", "crown_bounds_reference", "ibp_mlp_bounds",
           "relu_relaxation", "optimize_crown_alphas"]

Eps = Union[float, torch.Tensor]


def _is_scalar(eps: Eps) -> bool:
    return not isinstance(eps, torch.Tensor) or eps.dim() == 0


def relu_relaxation(l: torch.Tensor, u: torch.Tensor):
    """Per-neuron linear relaxation of ReLU on [l, u].

    Returns (a_up, b_up, a_lo, b_lo): a_up z + b_up >= relu(z) >= a_lo z + b_lo.
    """
    unstable = (l < 0) & (u > 0)
    on = (l >= 0).to(l.dtype)
    denom = torch.where(unstable, u - l, 1.0)
    a_up = torch.where(unstable, u / denom, on)
    b_up = torch.where(unstable, -u * l / denom, 0.0)
    a_lo = torch.where(unstable, (u >= -l).to(l.dtype), on)
    b_lo = torch.zeros_like(b_up)
    return a_up, b_up, a_lo, b_lo


def _concretise(Lu_t, Ll_t, cu, cl, eta0, eps: Eps):
    """Bounds of L eta + c over the box around eta0, for linear forms stored
    (N, k, out) with k the eta axis."""
    if _is_scalar(eps):
        r_u = eps * Lu_t.abs().sum(1)
        r_l = eps * Ll_t.abs().sum(1)
    else:
        r_u = torch.einsum("nko,nk->no", Lu_t.abs(), eps)
        r_l = torch.einsum("nko,nk->no", Ll_t.abs(), eps)
    ub = torch.einsum("nko,nk->no", Lu_t, eta0) + cu + r_u
    lb = torch.einsum("nko,nk->no", Ll_t, eta0) + cl - r_l
    return lb, ub


def _backward_from(layer_idx: int, Ws: Sequence[torch.Tensor],
                   bs: Sequence[torch.Tensor],
                   relax: Sequence[Tuple[torch.Tensor, ...]],
                   eta0: torch.Tensor, eps: Eps, x_bias: torch.Tensor):
    """CROWN backward pass bounding z_{layer_idx} (1-based pre-activation).

    ``relax[j]`` holds the relaxation of relu(z_{j+1}), each element
    (a_up, b_up, a_lo, b_lo) with the batch axis leading.  Returns
    elementwise (lb, ub) of z_{layer_idx}, batched over cells.
    """
    W = Ws[layer_idx - 1]
    b = bs[layer_idx - 1]
    N = eta0.shape[0]
    out_dim = W.shape[0]

    if layer_idx == 1:
        # z1 itself: exact affine in eta
        center = eta0 @ W.T + b + x_bias
        if _is_scalar(eps):
            radius = eps * W.abs().sum(-1)
        else:
            # per-row per-dim box half-widths (N, n): anisotropic sub-boxes
            radius = eps @ W.abs().T
        return center - radius, center + radius

    if layer_idx == 2 and out_dim >= Ws[0].shape[1]:
        # The second-layer bound absorbs only j = 1, whose linear forms are
        # still the static weight W, so the sign split collapses through
        #     W_pos u + W_neg l = [W (u + l) + |W| (u - l)] / 2
        # into two products with (N, k, in) operands (k the eta axis),
        # without the (N, out, in) intermediate of the general path.
        a_up, b_up, a_lo, b_lo = relax[0]
        W1, b1 = Ws[0], bs[0]
        b1_row = b1 + x_bias  # (N, in)
        W_abs = W.abs()
        # the relu upper / lower lines evaluated on the affine bias point
        u_vec = a_up * b1_row + b_up
        l_vec = a_lo * b1_row + b_lo
        s = (u_vec + l_vec) @ W.T
        d = (u_vec - l_vec) @ W_abs.T
        cu = b + 0.5 * (s + d)
        cl = b + 0.5 * (s - d)
        W1t = W1.T  # (k, in)
        Tsum = (a_up + a_lo)[:, None, :] * W1t[None]
        Tdiff = (a_up - a_lo)[:, None, :] * W1t[None]
        S = Tsum @ W.T       # (N, k, out)
        D = Tdiff @ W_abs.T
        return _concretise(0.5 * (S + D), 0.5 * (S - D), cu, cl, eta0, eps)

    # upper / lower linear forms: out <= Lu @ a_j + cu  (a_j = relu(z_j))
    Lu = W.expand(N, *W.shape)
    Ll = Lu
    cu = b.expand(N, out_dim)
    cl = cu

    for j in range(layer_idx - 1, 0, -1):
        a_up, b_up, a_lo, b_lo = relax[j - 1]
        # absorb relu(z_j): the upper form takes the up-line on positive
        # coefficients, the lower form the other way round
        Lu_pos, Lu_neg = Lu.clamp_min(0.0), Lu.clamp_max(0.0)
        cu = (cu + torch.einsum("noi,ni->no", Lu_pos, b_up)
              + torch.einsum("noi,ni->no", Lu_neg, b_lo))
        Lu = Lu_pos * a_up[:, None, :] + Lu_neg * a_lo[:, None, :]
        Ll_pos, Ll_neg = Ll.clamp_min(0.0), Ll.clamp_max(0.0)
        cl = (cl + torch.einsum("noi,ni->no", Ll_pos, b_lo)
              + torch.einsum("noi,ni->no", Ll_neg, b_up))
        Ll = Ll_pos * a_lo[:, None, :] + Ll_neg * a_up[:, None, :]
        # absorb the affine z_j = W_j a_{j-1} + b_j (+ x_bias at j == 1)
        Wj, bj = Ws[j - 1], bs[j - 1]
        if j == 1:
            bj = bj + x_bias
        bj = bj.expand(N, bj.shape[-1])
        cu = cu + torch.einsum("noi,ni->no", Lu, bj)
        cl = cl + torch.einsum("noi,ni->no", Ll, bj)
        Lu = Lu @ Wj
        Ll = Ll @ Wj

    # concretise: out <= Lu eta + cu over the Linf box around eta0
    return _concretise(Lu.transpose(1, 2), Ll.transpose(1, 2), cu, cl, eta0,
                       eps)


def _rows(x_bias: torch.Tensor, N: int) -> torch.Tensor:
    return x_bias.expand(N, x_bias.shape[0]) if x_bias.dim() == 1 else x_bias


def crown_mlp_bounds(Ws: Sequence[torch.Tensor], bs: Sequence[torch.Tensor],
                     eta0: torch.Tensor, eps: Eps, x_bias: torch.Tensor,
                     alphas: Optional[Sequence[torch.Tensor]] = None):
    """Elementwise output bounds of the ReLU MLP over the eta Linf box
    (arguments and result as ``crown_bounds_reference``): one launch of
    kernel K4 where ``fused_crown.takes`` the call, the plain chain
    otherwise."""
    if fused_crown.takes(Ws, bs, eta0, eps, x_bias, alphas):
        return fused_crown.fused_crown_bounds(Ws, bs, eta0, eps, x_bias,
                                              alphas)
    return crown_bounds_reference(Ws, bs, eta0, eps, x_bias, alphas)


def crown_bounds_reference(Ws: Sequence[torch.Tensor],
                           bs: Sequence[torch.Tensor], eta0: torch.Tensor,
                           eps: Eps, x_bias: torch.Tensor,
                           alphas: Optional[Sequence[torch.Tensor]] = None):
    """Elementwise output bounds of the ReLU MLP over the eta Linf box, in
    plain PyTorch (kernel K4's plain version).

    Args:
      Ws/bs: dense layer stack [(m1, n), (m2, m1), ..., (out, mk)]; for the
        dynamics [W1, W2, W3], with the U x contribution passed as
        ``x_bias`` added to layer 1's bias.
      eta0: (N, n) box centres (grid cells).
      eps: box half-widths: a scalar (the uniform 1/T grid cell) or a
        per-row per-dim (N, n) tensor (anisotropic sub-boxes).
      x_bias: (m1,) or (N, m1) static-input contribution U @ x_feat.
      alphas: optional alpha-CROWN lower-slope overrides, one (N, m_j)
        tensor per hidden layer, clipped to [0, 1].  Sound for any such
        value (relu(z) >= alpha z holds globally for alpha in [0, 1]), so
        they can be optimised against any objective.  Stable neurons keep
        their exact slopes regardless of the override.

    Returns: (lb, ub), each (N, out).
    """
    L = len(Ws)
    x_bias = _rows(x_bias, eta0.shape[0])
    relax = []
    for j in range(1, L):
        lj, uj = _backward_from(j, Ws, bs, relax, eta0, eps, x_bias)
        r = relu_relaxation(lj, uj)
        if alphas is not None:
            a_up, b_up, a_lo, b_lo = r
            unstable = (lj < 0) & (uj > 0)
            a_lo = torch.where(unstable, alphas[j - 1].clamp(0.0, 1.0), a_lo)
            r = (a_up, b_up, a_lo, b_lo)
        relax.append(r)
    return _backward_from(L, Ws, bs, relax, eta0, eps, x_bias)


def optimize_crown_alphas(Ws: Sequence[torch.Tensor],
                          bs: Sequence[torch.Tensor], eta0: torch.Tensor,
                          eps: Eps, x_bias: torch.Tensor, loss_fn: Callable,
                          iters: int = 8, lr: float = 0.25,
                          select_fn: Optional[Callable] = None):
    """Projected-gradient alpha-CROWN: pick lower slopes that minimise
    ``loss_fn(lb, ub) -> (N,)`` per cell.

    Each gradient step re-runs the full ``crown_mlp_bounds`` chain with the
    current alphas: intermediate pre-activation bounds are re-derived
    through the alpha-modified earlier layers on every iterate, not frozen.
    Every iterate is sound (any alpha in [0, 1] is a valid lower
    relaxation).  The steps are signed and decaying, and the best iterate is
    kept per cell, so the result is never worse than the heuristic start
    (iterate 0) under the scoring function.  Returns the optimised
    ``alphas`` list; pass it back into ``crown_mlp_bounds``.

    ``select_fn(lb, ub) -> (N,)``, when given, scores iterates for the
    per-cell best-tracking while ``loss_fn`` still drives the gradient.  Use
    it when the gradient objective is a surrogate (e.g. bound width):
    minimising a per-cell width sum does not imply elementwise [lb, ub]
    containment, so a width-optimal iterate may be worse under the certified
    quantity.

    When ``loss_fn`` composes these bounds with the barrier projection
    (``verify/ibp_qp.py``), the gradient does not differentiate the
    bisection: the projections carry closed-form active-set VJPs
    (``ops/simplex_qp.py``).

    The gradient is ``torch.autograd.grad`` of the summed per-cell loss;
    grad mode is switched on inside, so the caller may run under
    ``torch.no_grad()``.  The returned alphas carry no graph.
    """
    x_bias = _rows(x_bias, eta0.shape[0])
    L = len(Ws)

    def score(alphas):
        lb, ub = crown_mlp_bounds(Ws, bs, eta0, eps, x_bias, alphas)
        return (select_fn or loss_fn)(lb, ub)  # (N,)

    with torch.no_grad():
        # initial slopes = the standard heuristic
        relax = []
        for j in range(1, L):
            lj, uj = _backward_from(j, Ws, bs, relax, eta0, eps, x_bias)
            relax.append(relu_relaxation(lj, uj))
        alphas = [r[2] for r in relax]
        best = list(alphas)
        best_loss = score(alphas)

    for i in range(iters):
        with torch.enable_grad():
            leaves = [a.detach().requires_grad_() for a in alphas]
            lb, ub = crown_mlp_bounds(Ws, bs, eta0, eps, x_bias, leaves)
            grads = torch.autograd.grad(loss_fn(lb, ub).sum(), leaves)
        with torch.no_grad():
            step = lr / (1.0 + 0.5 * i)  # decaying signed steps: bounded domain
            alphas = [(a - step * torch.sign(g)).clamp(0.0, 1.0)
                      for a, g in zip(alphas, grads)]
            cur = score(alphas)
            better = cur < best_loss
            best = [torch.where(better[:, None], a, b)
                    for a, b in zip(alphas, best)]
            best_loss = torch.where(better, cur, best_loss)
    return best


def ibp_mlp_bounds(Ws, bs, eta0, eps: Eps, x_bias):
    """Pure interval propagation (looser; soundness cross-check)."""
    l = eta0 - eps
    u = eta0 + eps
    for i, (W, b) in enumerate(zip(Ws, bs)):
        c = 0.5 * (l + u)
        r = 0.5 * (u - l)
        cz = c @ W.T + b
        rz = r @ W.abs().T
        if i == 0:
            cz = cz + x_bias
        l, u = cz - rz, cz + rz
        if i < len(Ws) - 1:
            l, u = torch.relu(l), torch.relu(u)
    return l, u
