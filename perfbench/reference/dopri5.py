"""Plain reference of the adaptive dopri5 solve with batch-global RMS step
control (torchdiffeq semantics), to the end time only.

Frozen copy, at commit 08631d7, of ``fiode_tpu_torch/ode/integrate.py``
(``_rms``, ``rms_error_ratio``, ``_rk_step``, ``_initial_step``,
``_next_step_size``, ``_hermite``, ``_adaptive``) restricted to dopri5 and
ts = [0, t_max], with the Dormand-Prince tableau of
``fiode_tpu_torch/ode/tableaus.py``.  Imports nothing of the program.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["solve"]

SAFETY, IFACTOR, DFACTOR, ORDER = 0.9, 10.0, 0.2, 5

C = np.array([0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0])
A = np.zeros((7, 7))
for _i, _row in enumerate([
        [1 / 5],
        [3 / 40, 9 / 40],
        [44 / 45, -56 / 15, 32 / 9],
        [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729],
        [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656],
        [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84]]):
    A[_i + 1, :len(_row)] = _row
B = np.array([35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0])
B_HAT = np.array([5179 / 57600, 0.0, 7571 / 16695, 393 / 640,
                  -92097 / 339200, 187 / 2100, 1 / 40])
ERR = B - B_HAT


def _rms(r):
    return torch.sqrt(torch.mean(r * r))


def _step(f, t0, y0, f0, h):
    c, a, b, e = (torch.as_tensor(v, dtype=y0.dtype, device=y0.device)
                  for v in (C, A, B, ERR))
    ks = [f0]
    for i in range(1, 7):
        yi = y0
        for j in range(i):
            if A[i, j] != 0.0:
                yi = yi + (h * a[i, j]) * ks[j]
        ks.append(f(t0 + c[i] * h, yi))
    k = torch.stack(ks)
    return (y0 + h * torch.tensordot(b, k, dims=1), ks[-1],
            h * torch.tensordot(e, k, dims=1))


def _initial_step(f, t0, y0, f0, rtol, atol):
    scale = atol + y0.abs() * rtol
    d0, d1 = _rms(y0 / scale), _rms(f0 / scale)
    h0 = torch.where((d0 < 1e-5) | (d1 < 1e-5), 1e-6, 0.01 * d0 / d1)
    f1 = f(t0 + h0, y0 + h0 * f0)
    d2 = _rms((f1 - f0) / scale) / h0
    dmax = torch.maximum(d1, d2)
    h1 = torch.where(dmax <= 1e-15, torch.clamp_min(h0 * 1e-3, 1e-6),
                     (0.01 / dmax) ** (1.0 / (ORDER + 1)))
    return torch.minimum(100.0 * h0, h1)


def _next_h(h, ratio):
    dfactor = torch.where(ratio < 1.0, 1.0, DFACTOR)
    factor = torch.minimum(torch.full_like(h, IFACTOR), torch.maximum(
        SAFETY / torch.clamp_min(ratio, 1e-10) ** (1.0 / ORDER), dfactor))
    return torch.where(ratio == 0.0, h * IFACTOR, h * factor)


def _hermite(t, t0, y0, f0, t1, y1, f1):
    h = t1 - t0
    h = torch.where(h == 0, 1.0, h)
    s = (t - t0) / h
    s2, s3 = s * s, s * s * s
    return ((2 * s3 - 3 * s2 + 1) * y0 + ((s3 - 2 * s2 + s) * h) * f0
            + (-2 * s3 + 3 * s2) * y1 + ((s3 - s2) * h) * f1)


def solve(f, y0, t_max: float, rtol: float, atol: float, max_steps: int):
    """y(t_max) of dy/dt = f(t, y) from y0 at t = 0; returns (y, NFE,
    attempts)."""
    ts = torch.tensor([0.0, t_max], dtype=y0.dtype, device=y0.device)
    t_end_host = ts[-1].item()
    t, y = ts[0], y0
    fval = f(t, y0)
    h = _initial_step(f, t, y0, fval, rtol, atol)
    nfe, n_acc, n_rej, out = 2, 0, 0, None
    while out is None and n_acc + n_rej < max_steps:
        h = torch.minimum(h, ts[-1] - t)
        y1, f1, err = _step(f, t, y, fval, h)
        scale = atol + rtol * torch.maximum(y.abs(), y1.abs())
        ratio = _rms(err / scale)
        t1 = t + h
        ratio_host, t1_host = torch.stack([ratio, t1]).tolist()
        nfe += 6
        h_new = _next_h(h, ratio)
        if ratio_host <= 1.0:
            n_acc += 1
            if t_end_host <= t1_host:
                out = _hermite(ts[-1], t, y, fval, t1, y1, f1)
            t, y, fval = t1, y1, f1
        else:
            n_rej += 1
        h = h_new
    return (y if out is None else out), nfe, n_acc + n_rej
