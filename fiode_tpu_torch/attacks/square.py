"""Square Attack, gradient-free random search (counterpart of the
single-loop ``square_attack`` in ``fiode_tpu/attacks/square.py``).

Andriushchenko et al. 2020, Linf and L2:
  * Linf: at each query, resample one random square window of the
    perturbation to +/- eps per channel; accept iff the margin loss drops;
  * L2: refill a square window with a fresh gaussian bump and renormalise
    the whole perturbation to the eps sphere; accept on improvement;
  * window side: a fraction p of the pixels, halved at the iteration
    fractions [10, 50, 200, 500, 1000, 2000, 4000, 8000] / 10000.

Model queries only, no gradients.  Random draws come from an explicit
generator (on the input's device); the schedule is computed on the host.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

__all__ = ["square_attack", "square_random_start"]

_THRESHOLDS = np.asarray([0.001, 0.005, 0.02, 0.05, 0.1, 0.2, 0.4, 0.8],
                         np.float32)


def _margin_loss(logits, y):
    """CW margin z_y - max_{j != y} z_j (the attack succeeds when < 0)."""
    rows = torch.arange(logits.shape[0], device=logits.device)
    z_y = logits[rows, y]
    wrong = logits.clone()
    wrong[rows, y] = -torch.inf
    return z_y - wrong.amax(-1)


def _side(i: int, n_queries: int, p_init: float, H: int, W: int) -> int:
    """Window side at query i, in float32 as the JAX schedule computes it."""
    frac = np.float32(i) / np.float32(n_queries)
    halvings = int(np.sum(frac >= _THRESHOLDS))
    p = np.float32(p_init) * np.float32(0.5) ** np.float32(halvings)
    s = int(np.round(np.sqrt(p * np.float32(H) * np.float32(W))))
    return min(max(s, 1), min(H, W))


def square_random_start(x: torch.Tensor, eps: float, norm: str,
                        generator: Optional[torch.Generator]) -> torch.Tensor:
    """The start: vertical stripes of +/- eps per column (Linf), or a
    gaussian direction scaled to the eps sphere (L2); clipped to the box."""
    B, C, _, W = x.shape
    if norm == "Linf":
        bits = torch.randint(0, 2, (B, C, 1, W), generator=generator,
                             device=x.device)
        return torch.clamp(x + (2.0 * bits - 1.0) * eps, 0, 1)
    d = torch.randn(x.shape, generator=generator, device=x.device)
    nrm = torch.linalg.norm(d.reshape(B, -1), dim=-1).reshape(B, 1, 1, 1)
    return torch.clamp(x + d / torch.clamp_min(nrm, 1e-12) * eps, 0, 1)


def square_attack(logits_fn: Callable, x: torch.Tensor, y: torch.Tensor, *,
                  eps: float, norm: str = "L2", n_queries: int = 5000,
                  p_init: float = 0.8,
                  generator: Optional[torch.Generator] = None):
    """Returns (x_adv, success_mask)."""
    B, C, H, W = x.shape
    dev = x.device
    x = x.detach()
    with torch.no_grad():
        xa = square_random_start(x, eps, norm, generator)
        loss = _margin_loss(logits_fn(xa), y)
        rows = torch.arange(H, device=dev)[None, :]
        cols = torch.arange(W, device=dev)[None, :]
        for i in range(n_queries):
            s = _side(i, n_queries, p_init, H, W)
            # uniform over {0 .. H - s}, the u == 1 corner clamped
            u = torch.rand((2, B), generator=generator, device=dev)
            r0 = torch.clamp(torch.floor(u[0] * (H - s + 1)).long(), max=H - s)
            c0 = torch.clamp(torch.floor(u[1] * (W - s + 1)).long(), max=W - s)
            rmask = (rows >= r0[:, None]) & (rows < (r0 + s)[:, None])
            cmask = (cols >= c0[:, None]) & (cols < (c0 + s)[:, None])
            win = rmask[:, None, :, None] & cmask[:, None, None, :]
            if norm == "Linf":
                bits = torch.randint(0, 2, (B, C, 1, 1), generator=generator,
                                     device=dev)
                v = (2.0 * bits - 1.0) * eps
                cand = torch.where(win, torch.clamp(x + v, 0, 1), xa)
                cand = torch.clamp(torch.minimum(torch.maximum(cand, x - eps),
                                                 x + eps), 0, 1)
            else:
                bump = torch.randn(x.shape, generator=generator, device=dev)
                d_new = torch.where(win, bump, xa - x)
                nrm = torch.linalg.norm(d_new.reshape(B, -1), dim=-1)
                d_new = d_new / torch.clamp_min(nrm, 1e-12).reshape(
                    B, 1, 1, 1) * eps
                cand = torch.clamp(x + d_new, 0, 1)
            cand_loss = _margin_loss(logits_fn(cand), y)
            better = cand_loss < loss
            xa = torch.where(better.reshape(B, 1, 1, 1), cand, xa)
            loss = torch.minimum(loss, cand_loss)
    return xa, loss < 0
