"""ODE integration (counterpart of the ``while`` mode of
``fiode_tpu/ode/integrate.py``): the adaptive RK methods, the fixed-grid
solvers and ``scipy_solver``.

Adaptive methods (dopri5, dopri8, bosh3, fehlberg2, adaptive_heun), with
torchdiffeq semantics, as in the JAX package:

  * batch-global step control: the error norm is one RMS over the whole
    state tensor, so every batch row shares one step size; ``error_weight``
    (0 / 1, the state's shape) restricts it to a sub-state, the seminorm
    sum(w r^2) / max(sum w, 1), in the ratio and in the first-step
    heuristic;
  * Hairer first-step selection (initial NFE 2: f(t0, y0) plus the probe),
    I-controller with SAFETY 0.9, IFACTOR 10, DFACTOR 0.2, exponent 1/order;
  * an FSAL method costs s - 1 RHS evaluations per attempted step; another
    evaluates f(t1, y1) only when the step is accepted, and counts it then;
  * dopri8 (DOP853) scales its 5th-order error by d5 / sqrt(d5^2 +
    0.01 d3^2), where d5 and d3 are RMS means over the whole state;
  * dense output at the requested ``ts`` by cubic Hermite interpolation.

``t``, the step ``h`` and the error ratio stay float32 tensors on the
state's device, so accept/reject decisions match the float32 JAX solver.
The host reads one value pair per attempted step (the error ratio and the
candidate time), which decides acceptance.  Traced (``utils/tracing.py``)
as the spans ``odeint.first_step`` (f(t0, y0) and the first-step
heuristic) and ``odeint.attempt`` (one attempted step, its error ratio,
the host read ``odeint.host_read`` and the decision); the rejected
steps are counted as ``odeint.rejected``.

Fixed-grid methods (euler, midpoint, rk4, explicit_adams, implicit_adams,
fixed_adams) step from ts[i] to ts[i+1] in ceil(dt / step_size (1 - 1e-4))
equal substeps.  The Adams forms take an AB4 predictor after an rk4 start
and AM4 corrector passes (4 for implicit_adams, 1 for fixed_adams, none for
explicit_adams); their slope history runs across output segments and
starts again where the substep size changes by more than 1e-3 relative.
NFE counts every evaluation; n_accepted and n_rejected are 0.

``scipy_solver`` is scipy's ``solve_ivp`` RK45 on the host in float64,
whose RHS runs on the state's device in its dtype (not differentiable;
NFE 0, as in the JAX package).

Under autograd the adaptive and fixed loops are differentiable as they
run: every RHS evaluation, the step sizes (initial-step heuristic and
controller), the error ratios and the Hermite output stay in the graph,
none detached, so the gradient is the one ``jax.grad`` takes through the
JAX package's bounded ``scan`` mode (its masked trips past t_max contribute
nothing).  There is no scan mode here: the loop attempts only the steps it
needs.

With ``process_group`` (a ``torch.distributed`` group) the state is this
process's rows of a batch spread over the group's processes, and every RMS
of the adaptive step control (the error ratio, the first-step heuristic,
DOP853's d5 / d3) is taken over the whole batch: the sums of squares and
counts are all-reduced (``parallel.multihost.all_reduce_sum``, whose
backward all-reduces the gradient), so every process takes the
one-process solve's steps and the gradients through them.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..utils.tracing import count, span
from .tableaus import FIXED_SOLVERS, Tableau, get_tableau

__all__ = ["OdeSolution", "odeint", "rms_error_ratio"]

SAFETY = 0.9
IFACTOR = 10.0
DFACTOR = 0.2
N_CORRECTOR = {"implicit_adams": 4, "fixed_adams": 1, "explicit_adams": 0}


class OdeSolution(NamedTuple):
    ys: torch.Tensor  # (len(ts), *y0.shape)
    nfe: int          # RHS evaluations
    n_accepted: int
    n_rejected: int

    @property
    def attempts(self) -> int:
        """Steps attempted; equal to ``max_steps`` when the budget ran out."""
        return self.n_accepted + self.n_rejected


def _rms(r: torch.Tensor, weight: Optional[torch.Tensor] = None,
         group=None) -> torch.Tensor:
    if group is not None:
        return _group_rms(r, weight, group)
    if weight is None:
        return torch.sqrt(torch.mean(r * r))
    w = weight.to(r.dtype)
    return torch.sqrt(torch.sum(w * r * r) / torch.clamp_min(torch.sum(w), 1.0))


def _group_rms(r, weight, group):
    """The RMS over the rows of every process of ``group``."""
    from ..parallel.multihost import all_reduce_sum
    w = torch.ones_like(r) if weight is None else weight.to(r.dtype)
    sq, n = all_reduce_sum(torch.stack([torch.sum(w * r * r), torch.sum(w)]),
                           group)
    return torch.sqrt(sq / torch.clamp_min(n, 1.0))


def rms_error_ratio(err, rtol, atol, y0, y1, weight=None, group=None):
    """rms(err / (atol + rtol * max(|y0|, |y1|))) over the whole state (of
    every process of ``group``), or over the entries where ``weight`` is
    1."""
    scale = atol + rtol * torch.maximum(y0.abs(), y1.abs())
    return _rms(err / scale, weight, group)


def _const(v, y):
    return torch.as_tensor(v, dtype=y.dtype, device=y.device)


def _rk_step(tab: Tableau, f, t0, y0, f0, h, group=None):
    """One explicit RK step: (y1, the last stage's slope (f(t1, y1) for an
    FSAL method), the error estimate or None)."""
    c, a, b = (_const(v, y0) for v in (tab.c, tab.a, tab.b))
    ks = [f0]
    for i in range(1, len(tab.b)):
        yi = y0
        for j in range(i):
            if tab.a[i, j] != 0.0:
                yi = yi + (h * a[i, j]) * ks[j]
        ks.append(f(t0 + c[i] * h, yi))
    k = torch.stack(ks)
    y1 = y0 + h * torch.tensordot(b, k, dims=1)
    if tab.dop853_err:
        err5 = h * torch.tensordot(_const(tab.err5, y0), k, dims=1)
        err3 = h * torch.tensordot(_const(tab.err3, y0), k, dims=1)
        d5, d3 = _rms(err5, group=group), _rms(err3, group=group)
        denom = torch.sqrt(d5 * d5 + 0.01 * d3 * d3)
        err = err5 * (d5 / torch.clamp_min(denom, 1e-30))
    elif tab.err is not None:
        err = h * torch.tensordot(_const(tab.err, y0), k, dims=1)
    else:
        err = None
    return y1, ks[-1], err


def _initial_step(f, t0, y0, f0, order, rtol, atol, weight=None, group=None):
    """Hairer/Wanner first-step heuristic (torchdiffeq _select_initial_step)."""
    scale = atol + y0.abs() * rtol
    d0 = _rms(y0 / scale, weight, group)
    d1 = _rms(f0 / scale, weight, group)
    h0 = torch.where((d0 < 1e-5) | (d1 < 1e-5), 1e-6, 0.01 * d0 / d1)
    f1 = f(t0 + h0, y0 + h0 * f0)
    d2 = _rms((f1 - f0) / scale, weight, group) / h0
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


def _adaptive(tab: Tableau, f, y0, ts, ts_host, rtol, atol, max_steps,
              error_weight, group=None):
    n_out = len(ts_host)
    t = ts[0]
    t_final = ts[-1]
    with span("odeint.first_step"):
        fval = f(t, y0)
        h = _initial_step(f, t, y0, fval, tab.order, rtol, atol,
                          error_weight, group)
    y = y0
    ys = [y0] + [None] * (n_out - 1)
    out_idx, nfe, n_acc, n_rej = 1, 2, 0, 0
    while out_idx < n_out and n_acc + n_rej < max_steps:
        with span("odeint.attempt"):
            h = torch.minimum(h, t_final - t)
            y1, f1, err = _rk_step(tab, f, t, y, fval, h, group)
            ratio = rms_error_ratio(err, rtol, atol, y, y1, error_weight,
                                    group)
            t1 = t + h
            # the one host read of the step
            with span("odeint.host_read"):
                ratio_host, t1_host = torch.stack([ratio, t1]).tolist()
            nfe += len(tab.b) - 1
            h_new = _next_step_size(h, ratio, tab.order)
            if ratio_host <= 1.0:
                n_acc += 1
                if not tab.fsal:
                    # f(t1, y1), evaluated and counted on acceptance
                    f1 = f(t1, y1)
                    nfe += 1
                while out_idx < n_out and ts_host[out_idx] <= t1_host:
                    ys[out_idx] = _hermite(ts[out_idx], t, y, fval, t1, y1,
                                           f1)
                    out_idx += 1
                t, y, fval = t1, y1, f1
            else:
                n_rej += 1
                count("odeint.rejected")
            h = h_new
    ys = [y if yi is None else yi for yi in ys]
    return OdeSolution(torch.stack(ys), nfe, n_acc, n_rej)


def _fixed(method, f, y0, ts, ts_host, step_size):
    adams = method in N_CORRECTOR
    tab = get_tableau("rk4" if adams else method)
    n_corr = N_CORRECTOR.get(method, 0)
    f32 = np.float32
    y, ys, nfe = y0, [y0], 0
    hist, warm, h_prev = [], 0, f32(0.0)  # Adams: slopes f(t-3h) .. f(t)
    for k in range(len(ts_host) - 1):
        # float32 as in the JAX package; the 1e-4 relative slack keeps a
        # grid's rounding of dt from adding a substep
        dt = f32(ts_host[k + 1]) - f32(ts_host[k])
        n_sub = max(int(np.ceil(abs(dt) / f32(step_size) * f32(1.0 - 1e-4))), 1)
        h_host = dt / f32(n_sub)
        h = (ts[k + 1] - ts[k]) / n_sub
        if adams and not abs(h_host - h_prev) <= f32(1e-3) * abs(h_host):
            hist, warm = [], 0  # a new substep size: the history starts again
        h_prev = h_host
        for i in range(n_sub):
            t = ts[k] + float(i) * h
            f0 = f(t, y)
            nfe += 1
            if not adams:
                y, _, _ = _rk_step(tab, f, t, y, f0, h)
                nfe += len(tab.b) - 1
                continue
            hist = (hist + [f0])[-4:]
            warm = min(warm + 1, 4)
            if warm < 4:  # rk4 while the history is short
                y, _, _ = _rk_step(tab, f, t, y, f0, h)
                nfe += 3
                continue
            y_next = y + h / 24.0 * (55.0 * hist[3] - 59.0 * hist[2]
                                     + 37.0 * hist[1] - 9.0 * hist[0])
            for _ in range(n_corr):  # AM4 by functional iteration
                f1 = f(t + h, y_next)
                y_next = y + h / 24.0 * (9.0 * f1 + 19.0 * hist[3]
                                         - 5.0 * hist[2] + hist[1])
            nfe += n_corr
            y = y_next
        ys.append(y)
    return OdeSolution(torch.stack(ys), nfe, 0, 0)


def _scipy(f, y0, ts_host, rtol, atol):
    from scipy.integrate import solve_ivp

    shape, dev, dtype = y0.shape, y0.device, y0.dtype

    def rhs(t, y_flat):
        y = torch.as_tensor(y_flat.reshape(shape), dtype=dtype, device=dev)
        with torch.no_grad():
            dy = f(torch.tensor(t, dtype=dtype, device=dev), y)
        return dy.detach().cpu().numpy().reshape(-1)

    y_host = y0.detach().cpu().numpy().astype(np.float64).reshape(-1)
    sol = solve_ivp(rhs, (float(ts_host[0]), float(ts_host[-1])), y_host,
                    t_eval=np.asarray(ts_host, np.float64), rtol=float(rtol),
                    atol=float(atol), method="RK45")
    ys = sol.y.T.reshape((len(ts_host),) + tuple(shape)).astype(np.float32)
    return OdeSolution(torch.from_numpy(ys).to(dev), 0, 0, 0)


def odeint(f: Callable, y0: torch.Tensor, ts, *, method: str = "dopri5",
           rtol: float = 1e-3, atol: float = 1e-3,
           step_size: Optional[float] = None, max_steps: int = 512,
           error_weight: Optional[torch.Tensor] = None,
           process_group=None) -> OdeSolution:
    """Integrate dy/dt = f(t, y) and report y at each time in ``ts``.

    ``ts`` is 1-D and increasing; ts[0] is the initial time.  ``method`` is
    one of ``ADAPTIVE_SOLVERS``, ``FIXED_SOLVERS`` (which need
    ``step_size``) or ``"scipy_solver"``.  An adaptive method attempts at
    most ``max_steps`` steps; output times not reached by then are clamped
    to the last state (the JAX while mode's partial solution), and
    ``attempts == max_steps`` tells the caller so.  ``error_weight`` (0 / 1,
    y0's shape) restricts the adaptive error norm to a sub-state.
    ``process_group``: y0 is this process's rows of a batch spread over the
    group, and the adaptive error norms are the whole batch's (module
    docstring); ``scipy_solver`` refuses it.
    """
    ts = torch.as_tensor(ts, dtype=y0.dtype, device=y0.device)
    ts_host = ts.tolist()  # float32 values, exact as Python floats
    if method == "scipy_solver":
        if process_group is not None:
            raise ValueError("scipy_solver's step control is per process: "
                             "it takes no process_group")
        return _scipy(f, y0, ts_host, rtol, atol)
    if method in FIXED_SOLVERS:
        if step_size is None:
            raise ValueError(f"fixed-step method {method!r} needs step_size")
        return _fixed(method, f, y0, ts, ts_host, step_size)
    return _adaptive(get_tableau(method), f, y0, ts, ts_host, rtol, atol,
                     max_steps, error_weight, process_group)
