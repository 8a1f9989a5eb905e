"""Adaptive dopri5 integration (counterpart of the ``while`` mode of
``fiode_tpu/ode/integrate.py``).

torchdiffeq semantics, as in the JAX package:

  * batch-global step control: the error norm is one RMS over the whole
    state tensor, so every batch row shares one step size;
  * Hairer first-step selection (initial NFE 2: f(t0, y0) plus the probe),
    I-controller with SAFETY 0.9, IFACTOR 10, DFACTOR 0.2, exponent 1/order;
  * FSAL: each attempted step costs s - 1 = 6 RHS evaluations;
  * dense output at the requested ``ts`` by cubic Hermite interpolation.

``t``, the step ``h`` and the error ratio stay float32 tensors on the
state's device, so accept/reject decisions match the float32 JAX solver.
The host reads one value pair per attempted step (the error ratio and the
candidate time), which decides acceptance.

Under autograd the loop is differentiable as it runs: every RHS evaluation,
the step sizes (initial-step heuristic and controller), the error ratios
and the Hermite output stay in the graph, none detached, so the gradient is
the one ``jax.grad`` takes through the JAX package's bounded ``scan`` mode
(its masked trips past t_max contribute nothing).  There is no scan mode
here: the loop attempts only the steps it needs.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .tableaus import DOPRI5, Tableau

__all__ = ["OdeSolution", "odeint", "rms_error_ratio"]

SAFETY = 0.9
IFACTOR = 10.0
DFACTOR = 0.2


class OdeSolution(NamedTuple):
    ys: torch.Tensor  # (len(ts), *y0.shape)
    nfe: int          # RHS evaluations
    n_accepted: int
    n_rejected: int

    @property
    def attempts(self) -> int:
        """Steps attempted; equal to ``max_steps`` when the budget ran out."""
        return self.n_accepted + self.n_rejected


def _rms(r: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.mean(r * r))


def rms_error_ratio(err, rtol, atol, y0, y1):
    """rms(err / (atol + rtol * max(|y0|, |y1|))) over the whole state."""
    scale = atol + rtol * torch.maximum(y0.abs(), y1.abs())
    return _rms(err / scale)


def _rk_step(tab: Tableau, f, t0, y0, f0, h):
    """One explicit RK step: (y1, f1 = last stage slope, error estimate)."""
    c = torch.as_tensor(tab.c, dtype=y0.dtype, device=y0.device)
    a = torch.as_tensor(tab.a, dtype=y0.dtype, device=y0.device)
    b = torch.as_tensor(tab.b, dtype=y0.dtype, device=y0.device)
    e = torch.as_tensor(tab.err, dtype=y0.dtype, device=y0.device)
    ks = [f0]
    for i in range(1, len(tab.b)):
        yi = y0
        for j in range(i):
            if tab.a[i, j] != 0.0:
                yi = yi + (h * a[i, j]) * ks[j]
        ks.append(f(t0 + c[i] * h, yi))
    k = torch.stack(ks)
    y1 = y0 + h * torch.tensordot(b, k, dims=1)
    err = h * torch.tensordot(e, k, dims=1)
    return y1, ks[-1], err


def _initial_step(f, t0, y0, f0, order, rtol, atol):
    """Hairer/Wanner first-step heuristic (torchdiffeq _select_initial_step)."""
    scale = atol + y0.abs() * rtol
    d0 = _rms(y0 / scale)
    d1 = _rms(f0 / scale)
    h0 = torch.where((d0 < 1e-5) | (d1 < 1e-5), 1e-6, 0.01 * d0 / d1)
    f1 = f(t0 + h0, y0 + h0 * f0)
    d2 = _rms((f1 - f0) / scale) / h0
    dmax = torch.maximum(d1, d2)
    h1 = torch.where(
        dmax <= 1e-15,
        torch.clamp_min(h0 * 1e-3, 1e-6),
        (0.01 / dmax) ** (1.0 / (order + 1)),
    )
    return torch.minimum(100.0 * h0, h1)


def _next_step_size(h, error_ratio, order):
    """torchdiffeq _optimal_step_size, branchless."""
    dfactor = torch.where(error_ratio < 1.0, 1.0, DFACTOR)
    factor = torch.minimum(
        torch.full_like(h, IFACTOR),
        torch.maximum(
            SAFETY / torch.clamp_min(error_ratio, 1e-10) ** (1.0 / order),
            dfactor,
        ),
    )
    return torch.where(error_ratio == 0.0, h * IFACTOR, h * factor)


def _hermite(t, t0, y0, f0, t1, y1, f1):
    """Cubic Hermite interpolant on [t0, t1] evaluated at t."""
    h = t1 - t0
    h = torch.where(h == 0, 1.0, h)
    s = (t - t0) / h
    s2, s3 = s * s, s * s * s
    h00 = 2 * s3 - 3 * s2 + 1
    h10 = s3 - 2 * s2 + s
    h01 = -2 * s3 + 3 * s2
    h11 = s3 - s2
    return h00 * y0 + (h10 * h) * f0 + h01 * y1 + (h11 * h) * f1


def odeint(f: Callable, y0: torch.Tensor, ts, *, rtol: float = 1e-3,
           atol: float = 1e-3, max_steps: int = 512) -> OdeSolution:
    """Integrate dy/dt = f(t, y) with dopri5; report y at each time in ``ts``.

    ``ts`` is 1-D and increasing; ts[0] is the initial time.  At most
    ``max_steps`` steps are attempted; output times not reached by then are
    clamped to the last state (the JAX while mode's partial solution), and
    ``n_accepted + n_rejected == max_steps`` tells the caller so.
    """
    tab = DOPRI5
    ts = torch.as_tensor(ts, dtype=y0.dtype, device=y0.device)
    ts_host = ts.tolist()  # float32 values, exact as Python floats
    n_out = len(ts_host)
    t = ts[0]
    t_final = ts[-1]
    fval = f(t, y0)
    h = _initial_step(f, t, y0, fval, tab.order, rtol, atol)
    y = y0
    ys = [y0] + [None] * (n_out - 1)
    out_idx, nfe, n_acc, n_rej = 1, 2, 0, 0
    while out_idx < n_out and n_acc + n_rej < max_steps:
        h = torch.minimum(h, t_final - t)
        y1, f1, err = _rk_step(tab, f, t, y, fval, h)
        ratio = rms_error_ratio(err, rtol, atol, y, y1)
        t1 = t + h
        # the one host read of the step
        ratio_host, t1_host = torch.stack([ratio, t1]).tolist()
        nfe += len(tab.b) - 1
        h_new = _next_step_size(h, ratio, tab.order)
        if ratio_host <= 1.0:
            n_acc += 1
            while out_idx < n_out and ts_host[out_idx] <= t1_host:
                ys[out_idx] = _hermite(ts[out_idx], t, y, fval, t1, y1, f1)
                out_idx += 1
            t, y, fval = t1, y1, f1
        else:
            n_rej += 1
        h = h_new
    ys = [y if yi is None else yi for yi in ys]
    return OdeSolution(torch.stack(ys), nfe, n_acc, n_rej)
