"""Control-side Lyapunov / barrier functions (counterpart of
the JAX package's ``control/lyapunov_ctrl.py``):

  * ``LyaQuadratic``: V(x) = |P (x - goal)|^2, Vdot = <PᵀP x, f>;
  * ``SegwaySingleBarrierModel``: Vdot of a barrier along the closed loop,
    the object that is trained and certified;
  * the analytic barriers ``BarrierExt``, ``BarrierPhiV``,
    ``BarrierPhiDotV`` and ``BarrierV`` with their h_dot forms;
  * ``SegwayCompositeBarrierModel``: the minimum over member barriers.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

import numpy as np
import torch

__all__ = [
    "LyaQuadratic",
    "SegwaySingleBarrierModel",
    "SegwayCompositeBarrierModel",
    "BarrierExt",
    "BarrierPhiV",
    "BarrierPhiDotV",
    "BarrierV",
]


@dataclasses.dataclass
class LyaQuadratic:
    P: torch.Tensor  # (n, n), learnt in the barrier phase of training
    goal: torch.Tensor  # (1, n)

    def __call__(self, x):
        z = (x - self.goal) @ self.P.T
        return torch.sum(z * z, dim=-1, keepdim=True)

    def h_dot(self, x, f):
        # Vdot without the goal shift (the goal is 0 in practice), as the
        # JAX package has it
        grad = x @ (self.P.T @ self.P).T
        return torch.sum(grad * f, dim=-1, keepdim=True)

    def sigma_max(self) -> float:
        P = self.P.detach().cpu().numpy()
        return float(np.linalg.svd(P, compute_uv=False)[0])


@dataclasses.dataclass
class SegwaySingleBarrierModel:
    """Vdot(x) of ``barrier`` along the closed loop x' = dyn(x, ctrl(x))."""

    system: Callable  # Segway
    controller: Callable
    barrier: LyaQuadratic

    def closed_loop(self, x):
        return self.system(x, self.controller(x, 0.0))

    def __call__(self, x):
        return self.barrier.h_dot(x, self.closed_loop(x))


def _sided(side):
    return -1.0 if side == "lb" else 1.0


@dataclasses.dataclass
class BarrierExt:
    alpha: float
    alpha_ext: float
    side: str = "lb"

    def __call__(self, f, x):
        term = self.alpha * self.alpha_ext * math.pi / 12
        signed = (
            -f[..., 2:3]
            - (self.alpha + self.alpha_ext) * x[..., 2:3]
            - self.alpha * self.alpha_ext * x[..., 0:1]
        )
        return _sided(self.side) * signed + term

    def h_dot(self, f, x):
        signed = -f[..., 2:3] - self.alpha * x[..., 2:3]
        return _sided(self.side) * signed


@dataclasses.dataclass
class BarrierPhiV:
    alpha: float
    alpha_ext: float
    side: str = "lb"

    def __call__(self, f, x):
        term = self.alpha * self.alpha_ext * 3.0
        signed = (
            -x[..., 2:3]
            + self.alpha * f[..., 1:2]
            + self.alpha_ext * (-x[..., 0:1] + self.alpha * x[..., 1:2])
        )
        return _sided(self.side) * signed + term

    def h_dot(self, f, x):
        signed = -x[..., 2:3] + self.alpha * f[..., 1:2]
        return _sided(self.side) * signed


@dataclasses.dataclass
class BarrierPhiDotV:
    alpha: float
    alpha_ext: float
    side: str = "lb"

    def __call__(self, f, x):
        term = self.alpha * self.alpha_ext * 2.25
        signed = -(
            f[..., 2:3]
            + self.alpha * f[..., 1:2]
            + self.alpha_ext * (x[..., 2:3] + self.alpha * x[..., 1:2])
        )
        return _sided(self.side) * signed + term

    def h_dot(self, f, x):
        signed = -(f[..., 2:3] + self.alpha * f[..., 1:2])
        return _sided(self.side) * signed


@dataclasses.dataclass
class BarrierV:
    alpha: float
    alpha_ext: float
    side: str = "lb"

    def __call__(self, f, x):
        term = self.alpha_ext * 2.5
        signed = -(f[..., 1:2] + self.alpha_ext * x[..., 1:2])
        return _sided(self.side) * signed + term

    def h_dot(self, f, x):
        signed = -f[..., 1:2]
        return _sided(self.side) * signed


@dataclasses.dataclass
class SegwayCompositeBarrierModel:
    system: Callable
    controller: Callable
    barriers: Sequence

    def __call__(self, x):
        f = self.system(x, self.controller(x, 0.0))
        vals = [b(f, x) for b in self.barriers]
        out = vals[0]
        for v in vals[1:]:
            out = torch.minimum(out, v)
        return out

    def forward_adv(self, x):
        return torch.relu(-self(x))
