"""Simplex-projected Lipschitz ODE dynamics (counterpart of
``fiode_tpu/models/dynamics.py``):

    raw:      f~ = W3 a(W2 a(W1 h + U x + b1) + b2) + b3
    barrier:  lower = -alpha_1 (exp(sigma_1 h) - 1),  upper = alpha_2 (1 - h)
    scaling:  f~ <- (upper - lower) sigmoid(f~) + lower      [scale_nominal]
    project:  f = simplex_cone_project(lower, f~)

The four layers are CayleyLinear (``cayley=True``, what every config uses)
or LipsLinear.  Dropout acts inside the raw MLP only when the caller passes
``train=True``, as in the JAX package, never because of the module's
training mode; its mask is drawn from the caller's ``torch.Generator`` (on
the activations' device), kept with probability 1 - dropout and scaled by
1 / (1 - dropout), as flax's ``nn.Dropout`` does; with ``shard`` = (i, p)
the rows are part i of p equal parts of a global batch and the masks are
the global batch's rows of that part (``parallel.multihost.shard_rows``).  ``kappa`` and
``kappa_length`` are the Lyapunov training's decay rate and its annealing
length in steps; the RHS does not read them.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..ops.cayley import groupsort2
from ..parallel.multihost import shard_rows
from ..ops.simplex_qp import simplex_cone_project
from .layers import CayleyLinear, LipsLinear

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
                 cayley: bool = True, kappa: float = 2.0,
                 kappa_length: int = 0,
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
        self.cayley = cayley
        self.kappa = kappa
        self.kappa_length = kappa_length
        lin, g = (CayleyLinear if cayley else LipsLinear), generator
        self.hidden_to_mlp = lin(n_hidden, mlp_size, generator=g)
        self.U_x = lin(x_dim, mlp_size, generator=g)
        self.mlp_to_mlp = lin(mlp_size, mlp_size, generator=g)
        self.mlp_to_hidden = lin(mlp_size, n_hidden, generator=g)

    def _act(self, z):
        return groupsort2(z) if self.activation == "GroupSort" else torch.relu(z)

    def _drop(self, z, train: bool, generator: Optional[torch.Generator],
              shard=None):
        if not train or self.dropout == 0.0:
            return z
        keep = 1.0 - self.dropout
        u = shard_rows(lambda m: torch.rand((m,) + z.shape[1:],
                                            generator=generator,
                                            device=z.device), len(z), shard)
        return torch.where(u < keep, z / keep, torch.zeros((), device=z.device))

    def raw(self, h, x, *, train: bool = False,
            generator: Optional[torch.Generator] = None, shard=None):
        """The unprojected f~; dropout acts only with ``train``, its masks
        drawn from ``generator`` (for the part ``shard`` of a global
        batch)."""
        z = self.hidden_to_mlp(h) + self.U_x(x)
        z = self._act(self._drop(z, train, generator, shard))
        z = self.mlp_to_mlp(z)
        z = self._act(self._drop(z, train, generator, shard))
        return self.mlp_to_hidden(z)

    def eval_dot(self, h, x, *, train: bool = False,
                 generator: Optional[torch.Generator] = None,
                 scale_nominal: Optional[bool] = None, shard=None):
        """The projected dynamics f(h, x); ``scale_nominal`` overrides the
        module's own flag."""
        f_tilde = self.raw(h, x, train=train, generator=generator, shard=shard)
        lower, upper = barrier_bounds(h, self.alpha_1, self.sigma_1,
                                      self.alpha_2)
        sn = self.scale_nominal if scale_nominal is None else scale_nominal
        if sn:
            f_tilde = (upper - lower) * torch.sigmoid(f_tilde) + lower
        return simplex_cone_project(lower, f_tilde, self.qp_iters)

    def forward(self, h, x, **kw):
        return self.eval_dot(h, x, **kw)


def densify_dynamics_params(
        dyn: SimplexDynamics) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """Each layer as a dense (kernel (out, in), bias (out,)) pair, the
    Cayley weights baked to their orthogonal matrices (a LipsLinear's
    kernel is its weight)."""
    return {name: (getattr(dyn, name).kernel(), getattr(dyn, name).bias)
            for name in LAYERS}
