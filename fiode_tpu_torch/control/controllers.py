"""Controllers: constant, linear (LQR) and a ReLU MLP (counterpart of
the JAX package's ``control/controllers.py``).

The LQR design solves the continuous algebraic Riccati equation on the host
with scipy, in float64, from a float32 linearisation, as the JAX package
does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
from torch import nn

__all__ = [
    "ConstantController",
    "LinearController",
    "lqr_gain",
    "NNController",
]

# flax's truncated-normal variance scaling divides the std by the std of a
# unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


@dataclasses.dataclass
class ConstantController:
    value: float = 0.0

    def __call__(self, x, t=0.0):
        return torch.full(x.shape[:-1] + (1,), self.value, dtype=x.dtype,
                          device=x.device)


@dataclasses.dataclass
class LinearController:
    """u = -K x (the LQR feedback convention)."""

    K: np.ndarray  # (1, n)

    def __call__(self, x, t=0.0):
        K = torch.as_tensor(self.K, dtype=x.dtype, device=x.device)
        return -(x @ K.T)


def lqr_gain(system, goal, Q, R):
    """Continuous LQR about ``goal``: the float32 linearisation on the CPU,
    then scipy's CARE solver in float64.  Returns (K, P) as float32 numpy."""
    from scipy.linalg import solve_continuous_are

    goal = torch.as_tensor(goal, dtype=torch.float32).cpu().reshape(1, -1)
    u0 = torch.zeros(1, 1)
    A, B = system.jacobian(goal, u0)
    A = A[0].numpy().astype(np.float64)
    B = B[0].numpy().astype(np.float64)
    R = np.asarray(R, np.float64)
    P = solve_continuous_are(A, B, np.asarray(Q, np.float64), R)
    K = np.linalg.inv(R) @ B.T @ P
    return K.astype(np.float32), P.astype(np.float32)


def _lecun_normal(n_in: int, n_out: int, generator) -> torch.Tensor:
    """flax ``nn.Dense``'s kernel init (lecun_normal: fan_in variance
    scaling, truncated normal), drawn as the (out, in) weight."""
    std = math.sqrt(1.0 / n_in) / _TRUNC_STD
    w = torch.empty(n_out, n_in)
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)
    return w


class NNController(nn.Module):
    """ReLU MLP controller n_in -> hidden -> n_out, ``Dense_0`` and
    ``Dense_1`` as flax names them.

    Built without a generator its parameters are zero (to be loaded); with
    one, the kernels are drawn as flax's ``nn.Dense`` draws them and the
    biases are zero."""

    def __init__(self, n_in: int = 3, n_out: int = 1, hidden: int = 32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.Dense_0 = nn.utils.skip_init(nn.Linear, n_in, hidden)
        self.Dense_1 = nn.utils.skip_init(nn.Linear, hidden, n_out)
        with torch.no_grad():
            for layer in (self.Dense_0, self.Dense_1):
                layer.bias.zero_()
                if generator is None:
                    layer.weight.zero_()
                else:
                    layer.weight.copy_(_lecun_normal(
                        layer.in_features, layer.out_features, generator))

    @classmethod
    def create(cls, generator: torch.Generator, n_in=3, n_out=1, hidden=32):
        """Weights drawn from ``generator`` (a CPU generator); move the
        module to its device afterwards."""
        return cls(n_in, n_out, hidden, generator=generator)

    def forward(self, x, t=0.0):
        return self.Dense_1(torch.relu(self.Dense_0(x)))

    def dense_weights(self):
        """([W1, W2], [b1, b2]) with (out, in) matrices, for CROWN."""
        return ([self.Dense_0.weight.detach(), self.Dense_1.weight.detach()],
                [self.Dense_0.bias.detach(), self.Dense_1.bias.detach()])
