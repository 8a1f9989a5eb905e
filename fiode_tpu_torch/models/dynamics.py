"""Simplex-projected Lipschitz ODE dynamics (counterpart of
``fiode_tpu/models/dynamics.py``):

    raw:      f~ = W3 a(W2 a(W1 h + U x + b1) + b2) + b3
    barrier:  lower = -alpha_1 (exp(sigma_1 h) - 1),  upper = alpha_2 (1 - h)
    scaling:  f~ <- (upper - lower) sigmoid(f~) + lower      [scale_nominal]
    project:  f = simplex_cone_project(lower, f~)

The four layers are CayleyLinear (the JAX package's ``cayley=True``, the
only value its configs use).  Dropout acts inside the raw MLP only when the
caller passes ``train=True``, as in the JAX package, never because of the
module's training mode.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from ..ops.cayley import groupsort2
from ..ops.simplex_qp import simplex_cone_project
from .layers import CayleyLinear

__all__ = ["SimplexDynamics", "barrier_bounds", "densify_dynamics_params"]

LAYERS = ("hidden_to_mlp", "U_x", "mlp_to_mlp", "mlp_to_hidden")


def barrier_bounds(h, alpha_1, sigma_1, alpha_2):
    lower = -alpha_1 * (torch.exp(sigma_1 * h) - 1.0)
    upper = alpha_2 * (1.0 - h)
    return lower, upper


class SimplexDynamics(nn.Module):
    """f(h, x): simplex-cone-projected Lipschitz MLP dynamics."""

    def __init__(self, n_hidden: int = 10, mlp_size: int = 128,
                 x_dim: int = 10, activation: str = "ReLU",
                 dropout: float = 0.5, alpha_1: float = 100.0,
                 alpha_2: float = 20.0, sigma_1: float = 0.02,
                 scale_nominal: bool = False, qp_iters: int = 30,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if activation not in ("ReLU", "GroupSort"):
            raise ValueError(f"unknown activation {activation!r}")
        self.n_hidden = n_hidden
        self.mlp_size = mlp_size
        self.activation = activation
        self.dropout = dropout
        self.alpha_1 = alpha_1
        self.alpha_2 = alpha_2
        self.sigma_1 = sigma_1
        self.scale_nominal = scale_nominal
        self.qp_iters = qp_iters
        g = generator
        self.hidden_to_mlp = CayleyLinear(n_hidden, mlp_size, generator=g)
        self.U_x = CayleyLinear(x_dim, mlp_size, generator=g)
        self.mlp_to_mlp = CayleyLinear(mlp_size, mlp_size, generator=g)
        self.mlp_to_hidden = CayleyLinear(mlp_size, n_hidden, generator=g)

    def _act(self, z):
        return groupsort2(z) if self.activation == "GroupSort" else torch.relu(z)

    def raw(self, h, x, *, train: bool = False):
        """The unprojected f~; dropout acts only with ``train``."""
        z = self.hidden_to_mlp(h) + self.U_x(x)
        z = self._act(F.dropout(z, self.dropout, train))
        z = self.mlp_to_mlp(z)
        z = self._act(F.dropout(z, self.dropout, train))
        return self.mlp_to_hidden(z)

    def eval_dot(self, h, x, *, train: bool = False,
                 scale_nominal: Optional[bool] = None):
        """The projected dynamics f(h, x); ``scale_nominal`` overrides the
        module's own flag."""
        f_tilde = self.raw(h, x, train=train)
        lower, upper = barrier_bounds(h, self.alpha_1, self.sigma_1,
                                      self.alpha_2)
        sn = self.scale_nominal if scale_nominal is None else scale_nominal
        if sn:
            f_tilde = (upper - lower) * torch.sigmoid(f_tilde) + lower
        return simplex_cone_project(lower, f_tilde, self.qp_iters)

    def forward(self, h, x):
        return self.eval_dot(h, x)


def densify_dynamics_params(
        dyn: SimplexDynamics) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """Each layer as a dense (kernel (out, in), bias (out,)) pair, the
    Cayley weights baked to their orthogonal matrices."""
    return {name: (getattr(dyn, name).kernel(), getattr(dyn, name).bias)
            for name in LAYERS}
