"""The AutoAttack suite (counterpart of ``fiode_tpu/attacks/autoattack.py``).

  * test-time suite ['apgd-ce', 'apgd-t'];
  * 'standard' = [apgd-ce, apgd-t, fab-t, square].

Sequential composition: each attack runs on the full batch, and an example
counts as broken only if the attack's claim passes ``_validate``; the suite
returns the union of validated adversarials and the robust mask.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Sequence

import torch

from .apgd import apgd_ce, apgd_targeted
from .fab import fab_targeted
from .square import square_attack

__all__ = ["AutoAttackSuite", "STANDARD"]

STANDARD = ("apgd-ce", "apgd-t", "fab-t", "square")


class AutoAttackSuite:
    """``attacks_to_run``: a subset of {'apgd-ce', 'apgd-t', 'fab-t',
    'square'}, run in that order.  ``seconds`` accumulates each attack's
    wall time (its validation included) over calls of ``run``."""

    def __init__(self, logits_fn: Callable, *, eps: float, norm: str = "L2",
                 attacks_to_run: Sequence[str] = STANDARD, n_iter: int = 100,
                 square_queries: int = 5000):
        unknown = set(attacks_to_run) - set(STANDARD)
        if unknown:
            raise ValueError(f"unknown attacks {sorted(unknown)}")
        self.logits_fn = logits_fn
        self.eps = eps
        self.norm = norm
        self.attacks = tuple(attacks_to_run)
        self.n_iter = n_iter
        self.square_queries = square_queries
        self.seconds: Dict[str, float] = {name: 0.0 for name in self.attacks}

    def _attack(self, name, x, y, generator):
        kw = dict(eps=self.eps, norm=self.norm)
        if name == "apgd-ce":
            return apgd_ce(self.logits_fn, x, y, n_iter=self.n_iter,
                           generator=generator, **kw)
        if name == "apgd-t":
            return apgd_targeted(self.logits_fn, x, y, n_iter=self.n_iter,
                                 generator=generator, **kw)
        if name == "fab-t":
            return fab_targeted(self.logits_fn, x, y, n_iter=self.n_iter, **kw)
        return square_attack(self.logits_fn, x, y,
                             n_queries=self.square_queries,
                             generator=generator, **kw)

    def _validate(self, x, y, xb, succ):
        """Accept a claimed success only for a valid adversarial: finite,
        inside [0, 1], inside the eps-ball, and misclassified by a fresh
        forward pass (a NaN input is not an adversarial example, though
        argmax of NaN logits may differ from y)."""
        B = x.shape[0]
        flat = (xb - x).reshape(B, -1)
        if self.norm == "Linf":
            dist = flat.abs().amax(-1)
        else:
            dist = torch.linalg.norm(flat, dim=-1)
        in_ball = dist <= self.eps * (1 + 1e-5)
        finite = torch.isfinite(xb).reshape(B, -1).all(-1)
        in_range = ((xb >= 0.0) & (xb <= 1.0)).reshape(B, -1).all(-1)
        # a non-finite candidate is already refused; the fresh forward sees
        # the clean input in its place, so that one NaN row cannot stall
        # the batch-global step control of every other row
        keep = finite.reshape((B,) + (1,) * (x.ndim - 1))
        with torch.no_grad():
            lg = self.logits_fn(torch.where(keep, xb, x))
        mis = torch.isfinite(lg).all(-1) & (torch.argmax(lg, -1) != y)
        return succ & finite & in_ball & in_range & mis

    def run(self, x: torch.Tensor, y: torch.Tensor,
            generator: Optional[torch.Generator] = None):
        """Returns (x_adv, robust_mask)."""
        bshape = (x.shape[0],) + (1,) * (x.ndim - 1)
        with torch.no_grad():
            robust = torch.argmax(self.logits_fn(x), -1) == y
        x_adv = x
        for name in self.attacks:
            t0 = time.perf_counter()
            xb, succ = self._attack(name, x, y, generator)
            succ = self._validate(x, y, xb, succ)
            newly_broken = succ & robust
            x_adv = torch.where(newly_broken.reshape(bshape), xb, x_adv)
            robust = robust & ~succ
            if x.is_cuda:
                torch.cuda.synchronize(x.device)
            self.seconds[name] += time.perf_counter() - t0
        return x_adv, robust
