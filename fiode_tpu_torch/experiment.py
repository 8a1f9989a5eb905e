"""Attack evaluation (counterpart of ``run_autoattack`` in
``fiode_tpu/experiment.py``).

``run_autoattack`` takes a model and arrays (the JAX version takes a config
and restores a checkpoint), runs the AutoAttack suite over them in batches,
and returns the fields of the JAX package's artifact
(``run_data/certified_full/autoattack_*.json``).

Every forward the attacks make goes through ``BudgetedForward``, which
records the largest number of solver steps attempted and raises if any
solve used its whole ``max_steps`` budget: a truncated solve would make the
reported robust accuracy unsound.  A completion probe (the first batch, and
the eps-ball corner of each image) runs first, as in the JAX package.
"""
from __future__ import annotations

import json
import time
from typing import Optional, Sequence

import torch

from .attacks.autoattack import STANDARD, AutoAttackSuite
from .models.ivp import NeuralODEClassifier

__all__ = ["BudgetedForward", "run_autoattack"]


class BudgetedForward:
    """``model.predict`` that tracks the solver's attempted steps.

    ``max_attempts`` is the largest ``n_accepted + n_rejected`` of any solve
    so far, ``forwards`` the number of solves.  A solve that reaches the
    model's ``max_steps`` raises ``RuntimeError``.
    """

    def __init__(self, model: NeuralODEClassifier):
        self.model = model
        self.max_attempts = 0
        self.forwards = 0

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        sol = self.model.solve(x)
        self.forwards += 1
        self.max_attempts = max(self.max_attempts, sol.attempts)
        if sol.attempts >= self.model.max_steps:
            raise RuntimeError(
                f"solver hit the max_steps={self.model.max_steps} step "
                f"budget (attempts={sol.attempts}) in an attack forward: "
                "raise max_steps; attacking a truncated solve would be unsound"
            )
        return self.model.output_fn(sol.ys[-1])


def run_autoattack(model: NeuralODEClassifier, xs: torch.Tensor,
                   ys: torch.Tensor, *, eps: float = 36 / 255,
                   norm: str = "L2", attacks: Sequence[str] = STANDARD,
                   n_iter: int = 100, square_queries: int = 5000,
                   batch_size: int = 512, seed: int = 0,
                   out_path: Optional[str] = None):
    """Attack ``xs`` (N, C, H, W) in [0, 1] with labels ``ys`` (N,).

    Runs in eval mode with the model's parameters frozen (restored after),
    on the device ``xs`` lies on; random starts draw from one generator on
    that device seeded with ``seed``.  Returns ``(summary, x_adv)``:
    ``summary`` holds the artifact's fields plus ``max_attempts``,
    ``forwards`` and per-attack ``attack_seconds``; ``x_adv`` (N, C, H, W)
    holds each broken image's validated adversarial and the input
    elsewhere.  Writes ``summary`` as JSON to ``out_path`` if given.
    """
    forward = BudgetedForward(model)
    suite = AutoAttackSuite(forward, eps=eps, norm=norm,
                            attacks_to_run=attacks, n_iter=n_iter,
                            square_queries=square_queries)
    generator = torch.Generator(device=xs.device).manual_seed(seed)
    frozen = [p.requires_grad for p in model.parameters()]
    was_training = model.training
    model.eval().requires_grad_(False)
    try:
        # completion probe: clean images and an eps-ball corner of each
        probe = xs[:min(64, len(xs))]
        with torch.no_grad():
            forward(torch.cat([
                probe,
                torch.clamp(probe + eps * torch.sign(probe - 0.5), 0.0, 1.0),
            ]))
        probe_attempts = forward.max_attempts
        robust_idx, x_adv = [], []
        t0 = time.perf_counter()
        for i in range(0, len(xs), batch_size):
            bx, by = xs[i:i + batch_size], ys[i:i + batch_size]
            xa, robust = suite.run(bx, by, generator)
            robust_idx += (i + torch.nonzero(robust)[:, 0]).tolist()
            x_adv.append(xa)
        elapsed = time.perf_counter() - t0
    finally:
        for p, flag in zip(model.parameters(), frozen):
            p.requires_grad_(flag)
        model.train(was_training)
    n = len(xs)
    summary = {
        "attacks": list(attacks),
        "n_iter": n_iter,
        "square_queries": square_queries,
        "eps": eps,
        "norm": norm,
        "t_max": model.t_max,
        "max_steps": model.max_steps,
        "probe_attempts": probe_attempts,
        "max_attempts": forward.max_attempts,
        "forwards": forward.forwards,
        "n_images": n,
        "robust_acc": len(robust_idx) / max(n, 1),
        "robust_idx": robust_idx,
        "seconds": elapsed,
        "images_per_sec": n / max(elapsed, 1e-9),
        "attack_seconds": dict(suite.seconds),
    }
    if out_path:
        with open(out_path, "w") as fh:
            json.dump(summary, fh, indent=2)
    return summary, torch.cat(x_adv)
