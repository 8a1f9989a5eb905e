"""Neural-ODE classifier (counterpart of ``fiode_tpu/models/ivp.py``).

    x_feat = backbone(x);  h(0) = 1/n, the centre of the simplex
    dh/dt = dynamics(h, x_feat), adaptive dopri5 from 0 to t_max
    output = h(t_max), the class probabilities

There is one solve path, the JAX package's fused one: the dynamics are
densified once per solve and the input injection xc = x_feat U^T + bU + b1
is computed once, then every stage calls ``fused_rhs`` (kernel K1 on CUDA).

The solve is differentiable: xc keeps its graph into the backbone, and on
CUDA the RHS backward is kernel K2 (scale_nominal off or on) and each
conv's backward a K3 launch on Q^H.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ode.integrate import OdeSolution, odeint
from ..ops.fused_rhs import fused_rhs, pack_rhs_params
from .dynamics import SimplexDynamics, densify_dynamics_params

__all__ = ["NeuralODEClassifier"]


class NeuralODEClassifier(nn.Module):
    def __init__(self, backbone: Optional[nn.Module],
                 dynamics: SimplexDynamics, t_max: float = 1.0, rtol: float = 1e-3, atol: float = 1e-3,
                 max_steps: int = 512):
        super().__init__()
        self.backbone = backbone
        self.dynamics = dynamics
        self.t_max = t_max
        self.rtol = rtol
        self.atol = atol
        self.max_steps = max_steps

    # -- coordinate maps -----------------------------------------------------

    def features(self, x):
        return x if self.backbone is None else self.backbone(x)

    def h0(self, batch_size: int, device=None):
        """The simplex centre 1/n (the JAX package's UniformInitFun)."""
        n = self.dynamics.n_hidden
        return torch.full((batch_size, n), 1.0 / n, device=device)

    def output_fn(self, h):
        """h(t_max) is the class-probability vector (the "default" output)."""
        return h

    # -- solve ---------------------------------------------------------------

    def _fused_setup(self, feats):
        """Dense RHS weights and the input injection xc (B, mlp), once per
        solve."""
        dyn = self.dynamics
        if dyn.activation != "ReLU":
            raise ValueError(
                f"the fused RHS implements ReLU dynamics only, got "
                f"activation={dyn.activation!r}"
            )
        if dyn.training and dyn.dropout > 0:
            raise ValueError(
                "the fused RHS has no dropout: put the dynamics in eval mode "
                "or set dropout=0"
            )
        dense = densify_dynamics_params(dyn)
        W1, b1 = dense["hidden_to_mlp"]
        U, bU = dense["U_x"]
        W2, b2 = dense["mlp_to_mlp"]
        W3, b3 = dense["mlp_to_hidden"]
        p = pack_rhs_params(W1, W2, W3, b2, b3)
        xc = (torch.matmul(feats, U.T) + bU + b1).contiguous()
        return p, xc

    def solve(self, x, ts=None) -> OdeSolution:
        """Integrate from h0 and return the OdeSolution over ``ts``
        (default [0, t_max]); ``attempts`` on it counts the steps tried,
        which reach ``max_steps`` when the budget ran out."""
        dyn = self.dynamics
        feats = self.features(x)
        p, xc = self._fused_setup(feats)

        def f(t, h):
            return fused_rhs(h, xc, p, dyn.alpha_1, dyn.sigma_1, dyn.alpha_2,
                             dyn.scale_nominal, dyn.qp_iters)

        if ts is None:
            ts = [0.0, self.t_max]
        return odeint(f, self.h0(x.shape[0], x.device), ts, rtol=self.rtol,
                      atol=self.atol, max_steps=self.max_steps)

    def predict(self, x):
        """Class probabilities at t_max."""
        return self.output_fn(self.solve(x).ys[-1])
