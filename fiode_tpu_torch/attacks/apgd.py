"""Auto-PGD (APGD), the core of the AutoAttack suite (counterpart of
``fiode_tpu/attacks/apgd.py``).

Croce & Hein 2020 ("Reliable evaluation ..."):
  * checkpoint schedule p0 = 0, p1 = 0.22, p_{j+1} = p_j + max(p_j - p_{j-1}
    - 0.03, 0.06), w_j = ceil(p_j n_iter);
  * momentum update z = P(x_k + eta step), x_{k+1} = P(x_k + alpha (z - x_k)
    + (1 - alpha)(x_k - x_{k-1})), alpha = 0.75;
  * per-example step halving at checkpoints when (a) fewer than rho = 0.75
    of the steps since the last checkpoint improved the loss, or (b) the
    step was not halved last time and the best loss did not move; on
    halving, restart from the best point with its loss and gradient;
  * losses: untargeted cross-entropy ('apgd-ce') and the targeted DLR loss
    ('apgd-t', up to 9 target classes).

As in the JAX package, the model's simplex outputs are fed to the losses as
if they were logits, and gradients flow through the ODE solve.  The loop
runs batched over examples with per-example step sizes; the random start
is drawn by ``apgd_random_start`` from an explicit generator.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

__all__ = ["ce_loss", "dlr_loss_targeted", "apgd_attack", "apgd_ce",
           "apgd_targeted", "apgd_random_start"]


def _bshape(x):
    return (x.shape[0],) + (1,) * (x.ndim - 1)


def _checkpoints(n_iter: int):
    ps = [0.0, 0.22]
    while ps[-1] < 1.0:
        ps.append(ps[-1] + max(ps[-1] - ps[-2] - 0.03, 0.06))
    ws = sorted({int(math.ceil(p * n_iter)) for p in ps if p <= 1.0})
    return [w for w in ws if 0 < w < n_iter]


def _project(x, x0, eps, norm):
    d = x - x0
    if norm == "Linf":
        d = torch.clamp(d, -eps, eps)
    else:
        nrm = torch.linalg.norm(d.reshape(d.shape[0], -1), dim=-1)
        fac = torch.clamp(eps / torch.clamp_min(nrm, 1e-12), max=1.0)
        d = d * fac.reshape(_bshape(d))
    return torch.clamp(x0 + d, 0.0, 1.0)


def _normalize_grad(g, norm):
    if norm == "Linf":
        return torch.sign(g)
    n = torch.linalg.norm(g.reshape(g.shape[0], -1), dim=-1)
    return g / torch.clamp_min(n, 1e-12).reshape(_bshape(g))


def ce_loss(logits, y):
    """Per-example softmax cross-entropy."""
    return -torch.log_softmax(logits, -1).gather(-1, y[:, None])[:, 0]


def dlr_loss_targeted(logits, y, y_target):
    """Targeted DLR: -(z_y - z_t) / (z_(1) - (z_(3) + z_(4)) / 2)."""
    if logits.shape[-1] < 4:
        raise ValueError(
            "targeted DLR loss needs >= 4 classes "
            f"(got {logits.shape[-1]}); drop apgd-t/fab-t for this model"
        )
    srt = torch.sort(logits, dim=-1).values
    z_y = logits.gather(-1, y[:, None])[:, 0]
    z_t = logits.gather(-1, y_target[:, None])[:, 0]
    denom = srt[:, -1] - 0.5 * (srt[:, -3] + srt[:, -4])
    return -(z_y - z_t) / torch.clamp_min(denom, 1e-12)


def apgd_random_start(x: torch.Tensor, eps: float, norm: str,
                      generator: Optional[torch.Generator]) -> torch.Tensor:
    """The random start's offset: uniform in the Linf box, or a uniform
    direction times a uniform radius in [0, eps) for L2."""
    if norm == "Linf":
        u = torch.rand(x.shape, generator=generator, device=x.device)
        return (2.0 * u - 1.0) * eps
    d = torch.randn(x.shape, generator=generator, device=x.device)
    r = torch.rand(_bshape(x), generator=generator, device=x.device)
    return _normalize_grad(d, "L2") * eps * r


def _select(mask, a, b):
    return torch.where(mask.reshape((-1,) + (1,) * (a.ndim - 1)), a, b)


def apgd_attack(logits_fn: Callable[[torch.Tensor], torch.Tensor],
                x: torch.Tensor, y: torch.Tensor, *, eps: float,
                norm: str = "L2", n_iter: int = 100, loss: str = "ce",
                y_target: Optional[torch.Tensor] = None, rho: float = 0.75,
                alpha_mom: float = 0.75,
                generator: Optional[torch.Generator] = None):
    """One APGD run.  Returns (x_best, best_loss), best_loss the maximised
    objective per example."""
    B = x.shape[0]
    x = x.detach()
    if loss == "ce":
        loss_fn = lambda lg: ce_loss(lg, y)  # noqa: E731
    elif loss == "dlr-targeted":
        if y_target is None:
            raise ValueError("loss='dlr-targeted' needs y_target")
        loss_fn = lambda lg: dlr_loss_targeted(lg, y, y_target)  # noqa: E731
    else:
        raise ValueError(loss)

    def loss_and_grad(xa):
        xg = xa.detach().requires_grad_()
        with torch.enable_grad():
            lv = loss_fn(logits_fn(xg))
            (g,) = torch.autograd.grad(lv.sum(), xg)
        # a non-finite gradient component (the DLR denominator at its floor,
        # the bisection at saturation) would turn the next iterate NaN:
        # zero it, so the step uses the other components or momentum
        return lv.detach(), torch.where(torch.isfinite(g), g, 0.0)

    checkpoints = set(_checkpoints(n_iter))
    x0 = x
    xk = _project(x + apgd_random_start(x, eps, norm, generator), x0, eps,
                  norm)
    lv, g = loss_and_grad(xk)
    step = torch.full(_bshape(x), 2.0 * eps, device=x.device, dtype=x.dtype)
    x_prev = xk
    x_best, f_best, g_best = xk, lv, g
    f_best_prev_ck = lv
    step_halved_last = torch.zeros(B, dtype=torch.bool, device=x.device)
    succ_since_ck = torch.zeros(B, dtype=torch.int32, device=x.device)
    ck_size = 0
    for k in range(1, n_iter):
        z = _project(xk + step * _normalize_grad(g, norm), x0, eps, norm)
        x_new = _project(
            xk + alpha_mom * (z - xk) + (1 - alpha_mom) * (xk - x_prev),
            x0, eps, norm,
        )
        lv_new, g_new = loss_and_grad(x_new)
        # condition 1 counts per-step improvements f(x_{k+1}) > f(x_k)
        succ_since_ck = succ_since_ck + (lv_new > lv).to(torch.int32)
        # never promote a non-finite iterate to x_best
        finite = torch.isfinite(x_new).reshape(B, -1).all(-1)
        improved = (lv_new > f_best) & finite
        x_best = _select(improved, x_new, x_best)
        g_best = _select(improved, g_new, g_best)
        f_best = torch.maximum(f_best, lv_new)
        ck_size += 1
        if k in checkpoints:
            need = math.ceil(np.float32(rho) * np.float32(ck_size))
            halve = (succ_since_ck < need) | (
                ~step_halved_last & (f_best <= f_best_prev_ck))
            step = _select(halve, step * 0.5, step)
            x_new = _select(halve, x_best, x_new)
            g_new = _select(halve, g_best, g_new)
            lv_new = torch.where(halve, f_best, lv_new)
            f_best_prev_ck = f_best
            step_halved_last = halve
            succ_since_ck = torch.zeros_like(succ_since_ck)
            ck_size = 0
        x_prev, xk, g, lv = xk, x_new, g_new, lv_new
    return x_best, f_best


def _misclassified(logits_fn, x, y):
    with torch.no_grad():
        return torch.argmax(logits_fn(x), -1) != y


def apgd_ce(logits_fn, x, y, *, eps, norm="L2", n_iter=100, n_restarts=1,
            generator: Optional[torch.Generator] = None):
    """Untargeted APGD-CE; keeps the first successful adversarial per
    example across restarts (else the input)."""
    x_adv = x
    success = _misclassified(logits_fn, x, y)
    for _ in range(n_restarts):
        xb, _ = apgd_attack(logits_fn, x, y, eps=eps, norm=norm,
                            n_iter=n_iter, loss="ce", generator=generator)
        now = _misclassified(logits_fn, xb, y)
        x_adv = _select(now & ~success, xb, x_adv)
        success = success | now
    return x_adv, success


def target_classes(logits_clean, y, n_target_classes):
    """(T, B) targets: the classes ranked 2nd, 3rd, ... by the clean logits,
    the top class standing in where the ranked class is y."""
    order = torch.argsort(logits_clean, dim=-1, stable=True).flip(-1)
    n_targets = min(n_target_classes, logits_clean.shape[-1] - 1)
    return [torch.where(order[:, t] == y, order[:, 0], order[:, t])
            for t in range(1, n_targets + 1)]


def apgd_targeted(logits_fn, x, y, *, eps, norm="L2", n_iter=100,
                  n_target_classes=9,
                  generator: Optional[torch.Generator] = None):
    """APGD-T: DLR loss against each of the top-k other classes.

    The targets run one after another, each a full APGD over the batch
    with its own batch-global dopri5 step control, as each member of the
    JAX package's vmap over targets has; the per-example winner is the
    first successful target in rank order."""
    with torch.no_grad():
        logits_clean = logits_fn(x)
    success0 = torch.argmax(logits_clean, -1) != y
    found = torch.zeros_like(success0)
    x_pick = x
    for y_t in target_classes(logits_clean, y, n_target_classes):
        xb, _ = apgd_attack(logits_fn, x, y, eps=eps, norm=norm,
                            n_iter=n_iter, loss="dlr-targeted", y_target=y_t,
                            generator=generator)
        succ = _misclassified(logits_fn, xb, y)
        x_pick = _select(succ & ~found, xb, x_pick)
        found = found | succ
    x_adv = _select(found & ~success0, x_pick, x)
    return x_adv, success0 | found
