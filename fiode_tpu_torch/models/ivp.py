"""Neural-ODE classifier (counterpart of ``fiode_tpu/models/ivp.py``).

    x_feat = backbone(x);  h(0) = 1/n, the centre of the simplex
             ("uniform", the UniformInitFun) or 0 ("zeros", DefaultInitFun)
    dh/dt = dynamics(h, x_feat), integrated from 0 to t_max by ``method``
    output = h(t_max) ("default", the class probabilities), its first
             n_classes entries ("first_n"), or h(t_max) W^T with an
             (n_classes, n_hidden) weight and no bias ("linear")

The solve never applies dropout, in training mode or not (the JAX solve
integrates ``eval_dot`` without ``train``).  The configuration picks the
RHS, as in the JAX package, whose fused kernel is ReLU-only:

  * ReLU dynamics take the fused path: the dynamics are densified once per
    solve and the input injection xc = x_feat U^T + bU + b1 is computed
    once, then every stage calls ``fused_rhs`` (kernel K1 on CUDA);
  * GroupSort dynamics integrate ``dynamics.eval_dot`` (plain PyTorch).

The solve is differentiable two ways.  By default autograd runs through
the solver's steps: xc keeps its graph into the backbone, and on CUDA the
fused RHS's backward is kernel K2 (scale_nominal off or on) and each conv's
backward a K3 launch on Q^H; the GroupSort RHS's gradient is plain
autograd.  With ``use_adjoint=True`` the gradient is the continuous
adjoint (``ode/adjoint.py``, seminorm on).  For ReLU dynamics its
augmented RHS is ``fused_rhs`` then ``fused_rhs_vjp`` (K1 then K2 on CUDA)
on xc and the dense weights, K2 with weight gradients only where the
dynamics' parameters need a gradient; dxc and the dense weights' gradients
then go back through the densify and ``feats @ U^T`` by autograd, once.
That map does not depend on t, so this equals the JAX package's adjoint,
which integrates the raw parameters' and the features' adjoint.  GroupSort
dynamics take the autograd VJP of ``eval_dot`` on the features and the
dynamics' parameters.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..ode.adjoint import odeint_adjoint
from ..ode.integrate import OdeSolution, odeint
from ..ops.fused_rhs import RhsParams, fused_rhs, fused_rhs_vjp, pack_rhs_params
from .dynamics import SimplexDynamics, densify_dynamics_params

__all__ = ["NeuralODEClassifier", "LinearOutput"]

H0_INITS = ("uniform", "zeros")
OUTPUTS = ("default", "first_n", "linear")


class LinearOutput(nn.Module):
    """The "linear" readout h W^T, W (n_classes, n_hidden), no bias,
    xavier-uniform from ``generator``."""

    def __init__(self, n_hidden: int, n_classes: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        bound = math.sqrt(6.0 / (n_hidden + n_classes))
        w = torch.empty(n_classes, n_hidden)
        nn.init.uniform_(w, -bound, bound, generator=generator)
        self.weight = nn.Parameter(w)

    def forward(self, h):
        return h @ self.weight.T


class NeuralODEClassifier(nn.Module):
    def __init__(self, backbone: Optional[nn.Module],
                 dynamics: SimplexDynamics, t_max: float = 1.0,
                 rtol: float = 1e-3, atol: float = 1e-3,
                 max_steps: int = 512, n_classes: Optional[int] = None,
                 h0_init: str = "uniform", output: str = "default",
                 method: str = "dopri5",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if h0_init not in H0_INITS:
            raise ValueError(f"h0_init must be one of {H0_INITS}, got {h0_init!r}")
        if output not in OUTPUTS:
            raise ValueError(f"output must be one of {OUTPUTS}, got {output!r}")
        self.backbone = backbone
        self.dynamics = dynamics
        self.t_max = t_max
        self.rtol = rtol
        self.atol = atol
        self.max_steps = max_steps
        self.n_classes = dynamics.n_hidden if n_classes is None else n_classes
        self.h0_init = h0_init
        self.output_kind = output
        self.method = method
        # flax's params["output"]["kernel"]; drawn after the dynamics
        self.output = (LinearOutput(dynamics.n_hidden, self.n_classes, generator)
                       if output == "linear" else None)

    # -- coordinate maps -----------------------------------------------------

    def features(self, x):
        return x if self.backbone is None else self.backbone(x)

    def h0(self, batch_size: int, device=None):
        """The simplex centre 1/n ("uniform") or zeros ("zeros")."""
        n = self.dynamics.n_hidden
        if self.h0_init == "zeros":
            return torch.zeros((batch_size, n), device=device)
        return torch.full((batch_size, n), 1.0 / n, device=device)

    def output_fn(self, h):
        """The output coordinates of states h (..., n_hidden)."""
        if self.output_kind == "first_n":
            return h[..., :self.n_classes]
        if self.output_kind == "linear":
            return self.output(h)
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

    def _adjoint_fused(self, feats, h0, ts, consts, solver, stats):
        """The adjoint solve of ReLU dynamics: K1 then K2 on xc and, where
        the dynamics need them, the dense weights."""
        p, xc = self._fused_setup(feats)
        pd = RhsParams(*(t.detach() for t in p))
        pd.packed = p.packed
        weights = (torch.is_grad_enabled()
                   and any(q.requires_grad for q in self.dynamics.parameters()))
        params = (xc,) + (tuple(p) if weights else ())

        def f(t, h, params):
            return fused_rhs(h, params[0], pd, *consts)

        def vjp(t, h, a, params):
            fh = fused_rhs(h, params[0], pd, *consts)
            dh, dxc, dp = fused_rhs_vjp(h, params[0], a, pd, *consts,
                                        weight_grads=weights)
            return fh, dh, (dxc,) + (tuple(dp) if weights else ())

        return odeint_adjoint(f, h0, ts, params, vjp=vjp, stats=stats, **solver)

    def _adjoint_eval_dot(self, feats, h0, ts, sn, solver, stats):
        """The adjoint solve of GroupSort dynamics: the autograd VJP of
        ``eval_dot`` in the features and the dynamics' parameters."""
        dyn = self.dynamics
        named = [(k, q) for k, q in dyn.named_parameters() if q.requires_grad]
        names = [k for k, _ in named]

        def f(t, h, params):
            return torch.func.functional_call(
                dyn, dict(zip(names, params[1:])), (h, params[0]),
                {"scale_nominal": sn}, strict=False)

        return odeint_adjoint(f, h0, ts, (feats,) + tuple(q for _, q in named),
                              stats=stats, **solver)

    def solve(self, x, ts=None, *, scale_nominal: Optional[bool] = None,
              method: Optional[str] = None, step_size: Optional[float] = None,
              rtol: Optional[float] = None, atol: Optional[float] = None,
              use_adjoint: bool = False,
              adjoint_stats: Optional[dict] = None) -> OdeSolution:
        """Integrate from h0 and return the OdeSolution over ``ts``
        (default [0, t_max]); ``attempts`` on it counts the steps tried,
        which reach ``max_steps`` when the budget ran out.
        ``scale_nominal`` overrides the dynamics' own flag for this solve
        (a certifier integrates the field its certificate bounds);
        ``method``, ``rtol`` and ``atol`` the model's; a fixed-grid method
        needs ``step_size``.
        ``use_adjoint`` differentiates by the continuous adjoint;
        ``adjoint_stats`` (a dict) then receives its counts
        (``odeint_adjoint``'s ``stats``)."""
        dyn = self.dynamics
        feats = self.features(x)
        sn = dyn.scale_nominal if scale_nominal is None else scale_nominal
        solver = dict(
            method=method or self.method,
            rtol=self.rtol if rtol is None else rtol,
            atol=self.atol if atol is None else atol,
            step_size=step_size, max_steps=self.max_steps)
        if ts is None:
            ts = [0.0, self.t_max]
        h0 = self.h0(x.shape[0], x.device)
        consts = (dyn.alpha_1, dyn.sigma_1, dyn.alpha_2, sn, dyn.qp_iters)
        if use_adjoint:
            stats = {} if adjoint_stats is None else adjoint_stats
            if dyn.activation == "ReLU":
                ys = self._adjoint_fused(feats, h0, ts, consts, solver, stats)
            else:
                ys = self._adjoint_eval_dot(feats, h0, ts, sn, solver, stats)
            fwd = stats["forward"]
            return OdeSolution(ys, fwd.nfe, fwd.n_accepted, fwd.n_rejected)
        if dyn.activation == "ReLU":
            p, xc = self._fused_setup(feats)

            def f(t, h):
                return fused_rhs(h, xc, p, *consts)
        else:
            def f(t, h):
                return dyn.eval_dot(h, feats, train=False, scale_nominal=sn)
        return odeint(f, h0, ts, **solver)

    def predict(self, x, **kw):
        """The outputs at t_max; ``kw`` go to ``solve``."""
        return self.output_fn(self.solve(x, **kw).ys[-1])

    def trajectory(self, x, n_points: int = 100, **kw):
        """The outputs at ``n_points`` evenly spaced times in [0, t_max],
        (n_points, B, ...); ``kw`` go to ``solve``."""
        ts = torch.linspace(0.0, self.t_max, n_points)
        return self.output_fn(self.solve(x, ts, **kw).ys)
