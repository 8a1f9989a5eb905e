"""Lyapunov candidates V(h, y) and the certified-training loss (counterpart
of ``fiode_tpu/train/lyapunov.py``).

Candidates (per sample): cross_entropy, mse, one_minus_eta_y,
composite_cross_entropy (L1 / L2) and decision_boundary, the margin
1 + max_{j != y} p_j - p_y.  Its max is ``torch.amax``, whose derivative
averages over tied maxima as ``jnp.max``'s does (``torch.max(dim=...)``
would pick one): the decision-boundary sampler puts h exactly on such ties.

``lyapunov_loss`` takes V and Vdot = <grad V, f> from ONE forward-mode
``torch.func.jvp`` of the candidate along the projected dynamics f.  The
tangent f carries its graph to the weights, so ``backward`` on the loss
reaches them through Vdot; V enters the margin detached.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch
from torch.nn import functional as F

__all__ = ["get_lya_candidate", "anneal_kappa", "lips_kappa",
           "lyapunov_loss", "METRICS"]

_EPS = 1e-12

# the keys of the metrics dict lyapunov_loss returns (the JAX package's
# LyapunovMetrics fields)
METRICS = ("loss", "monte_carlo_loss", "barrier_loss", "kappa",
           "effective_batch_size", "mean_active_constraints", "mean_v",
           "mean_vdot")


def _logc(x):
    return torch.log(torch.clamp(x, min=_EPS))


def _p_y(probs, y):
    return torch.take_along_dim(probs, y[:, None], dim=-1)[:, 0]


def cross_entropy(probs, y, n):
    """-log p_y."""
    return -_logc(_p_y(probs, y))


def mse(probs, y, n):
    """Mean squared distance to the one-hot label."""
    onehot = F.one_hot(y, n).to(probs.dtype)
    return torch.mean((probs - onehot) ** 2, dim=-1)


def one_minus_eta_y(probs, y, n):
    """-p_y."""
    return -_p_y(probs, y)


def composite_cross_entropy_l1(probs, y, n):
    p_y = _p_y(probs, y)
    loss_tmp = -torch.sum(_logc(1 - probs), dim=-1)
    mod = _logc(1 - p_y) - _logc(p_y)
    return (loss_tmp + mod) / probs.shape[-1]


def composite_cross_entropy_l2(probs, y, n):
    p_y = _p_y(probs, y)
    lt = -_logc(1 - probs)
    mod = -_logc(1 - p_y) ** 2 + _logc(p_y) ** 2
    return (torch.sum(lt * lt, dim=-1) + mod) / probs.shape[-1]


def decision_boundary(probs, y, n, log_mode: bool = False):
    """V = 1 + max_{j != y} p_j - p_y; V < 1 iff classified correctly."""
    onehot = F.one_hot(y, n).bool()
    wrong = torch.where(onehot, torch.full_like(probs, -torch.inf), probs)
    v = 1.0 + torch.amax(wrong, dim=-1) - _p_y(probs, y)
    return torch.log(v) if log_mode else v


def get_lya_candidate(name: str, n: int, **kw) -> Callable:
    """V(probs, y) -> (N,) by the config's candidate name."""
    table = {
        "DynCrossEntropy": cross_entropy,
        "MSELoss": mse,
        "OnemEtay": one_minus_eta_y,
        "CompositeDynCrossEntropy": (
            composite_cross_entropy_l2
            if kw.get("norm_type", "L1") == "L2"
            else composite_cross_entropy_l1
        ),
        "DecisionBoundary": lambda p, y, n: decision_boundary(
            p, y, n, log_mode=kw.get("log_mode", False)
        ),
    }
    fn = table[name]
    return lambda probs, y: fn(probs, y, n)


def anneal_kappa(step: int, kappa: float, kappa_length: int) -> float:
    """Linear kappa annealing over ``kappa_length`` steps (float32, as the
    JAX package computes it)."""
    if kappa_length <= 0:
        return float(torch.tensor(kappa, dtype=torch.float32))
    frac = torch.clamp(torch.tensor(step, dtype=torch.float32)
                       / float(kappa_length), max=1.0)
    return float(frac * kappa)


def lips_kappa(step: int, kappa: float, kappa_length: int, eps: float,
               Lfx: torch.Tensor, lips_warmup: int) -> torch.Tensor:
    """Lipschitz-aware kappa max(eps_t sqrt(2) Lfx, kappa) + 1, eps_t
    ramped linearly over kappa_length steps after ``lips_warmup``."""
    stepf = torch.tensor(step, dtype=torch.float32, device=Lfx.device)
    length = max(float(kappa_length), 1.0)
    ramp = torch.clamp((stepf - lips_warmup) / length, 0.0, 1.0)
    current_eps = ramp * eps
    sqrt2 = torch.sqrt(torch.tensor(2.0, device=Lfx.device))
    return torch.clamp(current_eps * sqrt2 * Lfx, min=kappa) + 1.0


def lyapunov_loss(*, h, f, f_tilde, y, lya_cand: Callable,
                  output_fn: Callable, current_kappa, alpha_1: float,
                  alpha_2: float, act: str = "relu",
                  relax_exp_stable: bool = False, scale_l_eps: float = 3.0,
                  eps: float = 36 / 255, barrier_loss: bool = False
                  ) -> tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Monte-Carlo certified-training loss mean act(Vdot + kappa V) over the
    sampled states h (N, n) with projected dynamics f (N, n) and labels y;
    returns (loss, metrics keyed by ``METRICS``)."""
    v, vdot = torch.func.jvp(lambda h_: lya_cand(output_fn(h_), y), (h,), (f,))

    margin = current_kappa * v.detach()
    if relax_exp_stable:
        margin = torch.clamp(margin, max=scale_l_eps * alpha_1 * eps)

    z = vdot + margin
    if act == "relu":
        violations = torch.relu(z)
    elif act == "elu":
        violations = F.elu(z)
    else:
        violations = z

    mc_loss = torch.mean(violations)
    eff_bs = torch.sum(violations > 0).to(torch.float32)

    # diagnostics: the share of coordinates on the linear barrier
    lower_lin = -alpha_1 * h
    upper_lin = alpha_2 * (1.0 - h)
    fd = f.detach()
    active = ((fd - lower_lin).abs() <= 1e-6) | ((fd - upper_lin).abs() <= 1e-6)
    mean_active = torch.mean(active.to(torch.float32))

    # logged, never added to the objective (as in the JAX package)
    zero = torch.zeros((), device=h.device)
    if barrier_loss and f_tilde is not None:
        b_loss = (100.0 * torch.mean(torch.relu(f_tilde - upper_lin))
                  + torch.mean(torch.relu(lower_lin - f_tilde))).detach()
    else:
        b_loss = zero
    kappa = torch.as_tensor(current_kappa, dtype=torch.float32,
                            device=h.device)
    metrics = dict(
        loss=mc_loss.detach(), monte_carlo_loss=mc_loss.detach(),
        barrier_loss=b_loss, kappa=kappa.detach(),
        effective_batch_size=eff_bs, mean_active_constraints=mean_active,
        mean_v=torch.mean(v.detach()), mean_vdot=torch.mean(vdot.detach()),
    )
    return mc_loss, metrics
