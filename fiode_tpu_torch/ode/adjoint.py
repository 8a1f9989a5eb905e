"""Continuous adjoint through an adaptive solve (counterpart of
``fiode_tpu/ode/adjoint.py``): memory that does not grow with the steps.

``odeint_adjoint(f, y0, ts, params)`` returns ``odeint(...).ys``; its
backward integrates the augmented state [y, a_y, a_p] from each output time
back to the previous one, in s = -t:

    dy/ds = -f(t, y),   da_y/ds = a_y^T df/dy,   da_p/ds = a_y^T df/dp

adding the cotangent of ys[i] to a_y at each output time.  The three parts
are one flat vector, so the step control is the one RMS of the JAX
package; with ``seminorm`` (the default) its error norm covers y and a_y
only, not the parameter adjoint.  The gradients of y0 and of every tensor
in ``params`` are returned, that of ``ts`` is zeros.

``f(t, y, params)`` reads the parameters from its third argument.  The
augmented RHS takes ``vjp(t, y, a, params) -> (f, a^T df/dy, (a^T df/dp
for each p))`` where the caller has one (the classifier's ReLU dynamics:
kernels K1 and K2 on CUDA); the default is ``torch.autograd.grad`` on f.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from .integrate import odeint

__all__ = ["odeint_adjoint"]


def autograd_vjp(f: Callable) -> Callable:
    """The VJP of ``f`` by ``torch.autograd.grad``: (f, a^T df/dy, a^T
    df/dp), zeros for a parameter f does not read."""
    def vjp(t, y, a, params):
        with torch.enable_grad():
            y = y.detach().requires_grad_()
            ps = [p.detach().requires_grad_() for p in params]
            out = f(t, y, ps)
            grads = torch.autograd.grad(out, [y] + ps, a, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for g, x in zip(grads, [y] + ps)]
        return out.detach(), grads[0], tuple(grads[1:])
    return vjp


class _Adjoint(torch.autograd.Function):
    @staticmethod
    def forward(ctx, opts, y0, ts, *params):
        sol = odeint(lambda t, y: opts["f"](t, y, params), y0, ts,
                     **opts["solver"])
        stats = opts["stats"]
        if stats is not None:
            stats.update(forward=sol)
        ctx.opts = opts
        ctx.save_for_backward(sol.ys, ts, *params)
        return sol.ys

    @staticmethod
    def backward(ctx, g):
        ys, ts, *params = ctx.saved_tensors
        opts = ctx.opts
        vjp = opts["vjp"] or autograd_vjp(opts["f"])
        params = [p.detach() for p in params]
        shape = ys.shape[1:]
        n_y = ys[0].numel()
        sizes = [p.numel() for p in params]
        n_p = sum(sizes)

        def aug_f(s, state):
            y = state[:n_y].view(shape)
            a_y = state[n_y:2 * n_y].view(shape)
            fy, va_y, va_p = vjp(-s, y, a_y, params)
            return torch.cat([-fy.reshape(-1), va_y.reshape(-1)]
                             + [v.reshape(-1) for v in va_p])

        weight = None
        if opts["seminorm"] and n_p > 0:
            weight = torch.cat([ys.new_ones(2 * n_y), ys.new_zeros(n_p)])
        a_y = ys.new_zeros(n_y)
        a_p = ys.new_zeros(n_p)
        nfe = n_acc = n_rej = 0
        for i in range(ys.shape[0] - 1, 0, -1):  # output times backwards
            a_y = a_y + g[i].reshape(-1)
            state0 = torch.cat([ys[i].reshape(-1), a_y, a_p])
            sol = odeint(aug_f, state0, torch.stack([-ts[i], -ts[i - 1]]),
                         error_weight=weight, **opts["solver"])
            a_y = sol.ys[-1][n_y:2 * n_y]
            a_p = sol.ys[-1][2 * n_y:]
            nfe, n_acc, n_rej = (nfe + sol.nfe, n_acc + sol.n_accepted,
                                 n_rej + sol.n_rejected)
        a_y = a_y + g[0].reshape(-1)
        if opts["stats"] is not None:
            opts["stats"].update(backward_nfe=nfe, backward_accepted=n_acc,
                                 backward_rejected=n_rej)
        d_params = [d.view_as(p) for d, p in zip(a_p.split(sizes), params)]
        return (None, a_y.view(shape), torch.zeros_like(ts), *d_params)


def odeint_adjoint(f: Callable, y0: torch.Tensor, ts,
                   params: Sequence[torch.Tensor] = (), *,
                   method: str = "dopri5", rtol: float = 1e-3,
                   atol: float = 1e-3, step_size: Optional[float] = None,
                   max_steps: int = 512, seminorm: bool = True,
                   vjp: Optional[Callable] = None,
                   stats: Optional[dict] = None) -> torch.Tensor:
    """``odeint(...).ys`` of dy/dt = f(t, y, params), differentiated by the
    continuous adjoint in y0 and ``params``.

    ``vjp(t, y, a, params)`` gives (f, a^T df/dy, a^T df/dp per parameter);
    without it the backward differentiates f by autograd.  ``stats``, a
    dict, receives the forward's ``OdeSolution`` under "forward" and, once
    the backward ran, its summed "backward_nfe", "backward_accepted" and
    "backward_rejected".
    """
    ts = torch.as_tensor(ts, dtype=y0.dtype, device=y0.device)
    opts = {"f": f, "vjp": vjp, "seminorm": seminorm, "stats": stats,
            "solver": dict(method=method, rtol=rtol, atol=atol,
                           step_size=step_size, max_steps=max_steps)}
    return _Adjoint.apply(opts, y0, ts, *params)
