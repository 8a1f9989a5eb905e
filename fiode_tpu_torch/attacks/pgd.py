"""PGD adversarial attack, Linf or L2 (counterpart of
``fiode_tpu/attacks/pgd.py``).

Maximises ``sum(loss_fn(x_adv))`` over the eps-ball around x with ``steps``
signed (Linf) or normalised (L2) gradient steps, differentiating through
whatever the objective contains, the ODE solve included.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..parallel.multihost import shard_rows

__all__ = ["pgd_attack", "pgd_random_start"]


def _bshape(x):
    return (x.shape[0],) + (1,) * (x.ndim - 1)


def _l2_normalize(g, eps=1e-12):
    n = torch.linalg.norm(g.reshape(g.shape[0], -1), dim=-1)
    return g / (n.reshape(_bshape(g)) + eps)


def _project(x, x0, eps, norm):
    d = x - x0
    if norm == "Linf":
        d = torch.clamp(d, -eps, eps)
    else:  # L2
        n = torch.linalg.norm(d.reshape(d.shape[0], -1), dim=-1)
        scale = torch.clamp(eps / torch.clamp_min(n, 1e-12), max=1.0)
        d = d * scale.reshape(_bshape(d))
    return x0 + d


def pgd_random_start(x: torch.Tensor, eps: float, norm: str,
                     generator: Optional[torch.Generator],
                     shard=None) -> torch.Tensor:
    """The random start's offset: uniform in the Linf box, or a uniform
    direction times a uniform radius in [0, eps) for L2; with ``shard`` =
    (i, p), x's rows of a global batch's draws (``shard_rows``)."""
    def rows(m):
        shape = (m,) + x.shape[1:]
        if norm == "Linf":
            return torch.rand(shape, generator=generator, device=x.device)
        return (torch.randn(shape, generator=generator, device=x.device),
                torch.rand((m,) + _bshape(x)[1:], generator=generator,
                           device=x.device))

    if norm == "Linf":
        return (2.0 * shard_rows(rows, len(x), shard) - 1.0) * eps
    d, r = shard_rows(rows, len(x), shard)
    return _l2_normalize(d) * r * eps


def pgd_attack(loss_fn: Callable[[torch.Tensor], torch.Tensor],
               x: torch.Tensor, *, eps: float, norm: str = "L2",
               steps: int = 7, step_size: Optional[float] = None,
               rand_init: bool = True, clip_min: float = 0.0,
               clip_max: float = 1.0,
               generator: Optional[torch.Generator] = None,
               shard=None) -> torch.Tensor:
    """Maximise ``sum(loss_fn(x_adv))`` over the eps-ball around x.

    loss_fn returns per-example losses (summed, so gradients stay per
    example).  The random start draws from ``generator`` (x's rows of a
    global batch's draws with ``shard``, see ``pgd_random_start``).
    """
    if step_size is None:
        step_size = 2.5 * eps / steps
    x = x.detach()
    xa = x
    if rand_init:
        xa = torch.clamp(x + pgd_random_start(x, eps, norm, generator, shard),
                         clip_min, clip_max)
    for _ in range(steps):
        xg = xa.detach().requires_grad_()
        with torch.enable_grad():
            (g,) = torch.autograd.grad(loss_fn(xg).sum(), xg)
        if norm == "Linf":
            xa = xa + step_size * torch.sign(g)
        else:
            xa = xa + step_size * _l2_normalize(g)
        xa = torch.clamp(_project(xa, x, eps, norm), clip_min, clip_max)
    return xa.detach()
