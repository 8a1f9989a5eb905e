"""Neural-ODE classifier (counterpart of ``fiode_tpu/models/ivp.py``).

    x_feat = backbone(x);  h(0) = 1/n, the centre of the simplex
    dh/dt = dynamics(h, x_feat), adaptive dopri5 from 0 to t_max
    output = h(t_max), the class probabilities

The solve never applies dropout, in training mode or not (the JAX solve
integrates ``eval_dot`` without ``train``).  The configuration picks the
RHS, as in the JAX package, whose fused kernel is ReLU-only:

  * ReLU dynamics take the fused path: the dynamics are densified once per
    solve and the input injection xc = x_feat U^T + bU + b1 is computed
    once, then every stage calls ``fused_rhs`` (kernel K1 on CUDA);
  * GroupSort dynamics integrate ``dynamics.eval_dot`` (plain PyTorch).

The solve is differentiable: xc keeps its graph into the backbone, and on
CUDA the fused RHS's backward is kernel K2 (scale_nominal off or on) and
each conv's backward a K3 launch on Q^H; the GroupSort RHS's gradient is
plain autograd.
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

    # -- the dynamics as a pure RHS ------------------------------------------

    def eval_dot(self, h, x_feat, *, train: bool = False,
                 generator: Optional[torch.Generator] = None,
                 scale_nominal: Optional[bool] = None):
        """f(h, x_feat) in plain PyTorch: with ``train`` the dropout masks
        are drawn from ``generator`` (no kernel takes a mask)."""
        return self.dynamics.eval_dot(h, x_feat, train=train,
                                      generator=generator,
                                      scale_nominal=scale_nominal)

    def raw_dot(self, h, x_feat, *, train: bool = False,
                generator: Optional[torch.Generator] = None):
        """The unprojected f~(h, x_feat)."""
        return self.dynamics.raw(h, x_feat, train=train, generator=generator)

    # -- solve ---------------------------------------------------------------

    def _fused_setup(self, feats):
        """Dense RHS weights and the input injection xc (B, mlp), once per
        solve (ReLU dynamics)."""
        dense = densify_dynamics_params(self.dynamics)
        W1, b1 = dense["hidden_to_mlp"]
        U, bU = dense["U_x"]
        W2, b2 = dense["mlp_to_mlp"]
        W3, b3 = dense["mlp_to_hidden"]
        p = pack_rhs_params(W1, W2, W3, b2, b3)
        xc = (torch.matmul(feats, U.T) + bU + b1).contiguous()
        return p, xc

    def solve(self, x, ts=None, *,
              scale_nominal: Optional[bool] = None) -> OdeSolution:
        """Integrate from h0 and return the OdeSolution over ``ts``
        (default [0, t_max]); ``attempts`` on it counts the steps tried,
        which reach ``max_steps`` when the budget ran out.
        ``scale_nominal`` overrides the dynamics' own flag for this solve
        (a certifier integrates the field its certificate bounds)."""
        dyn = self.dynamics
        feats = self.features(x)
        sn = dyn.scale_nominal if scale_nominal is None else scale_nominal
        if dyn.activation == "ReLU":
            p, xc = self._fused_setup(feats)

            def f(t, h):
                return fused_rhs(h, xc, p, dyn.alpha_1, dyn.sigma_1,
                                 dyn.alpha_2, sn, dyn.qp_iters)
        else:
            def f(t, h):
                return dyn.eval_dot(h, feats, train=False, scale_nominal=sn)

        if ts is None:
            ts = [0.0, self.t_max]
        return odeint(f, self.h0(x.shape[0], x.device), ts, rtol=self.rtol,
                      atol=self.atol, max_steps=self.max_steps)

    def predict(self, x):
        """Class probabilities at t_max."""
        return self.output_fn(self.solve(x).ys[-1])

    def trajectory(self, x, n_points: int = 100, *,
                   scale_nominal: Optional[bool] = None):
        """The outputs at ``n_points`` evenly spaced times in [0, t_max],
        (n_points, B, n)."""
        ts = torch.linspace(0.0, self.t_max, n_points)
        return self.output_fn(self.solve(x, ts, scale_nominal=scale_nominal).ys)
