"""Interval arithmetic over tensors, for bounding analytic dynamics
(counterpart of the JAX package's ``verify/interval.py``).

The Segway certifier propagates bounds through the closed-loop graph
Vdot(x) = <PᵀP x, f(x, u(x))>: CROWN (``verify/crown.py``) bounds the ReLU
controller, and this module the analytic trigonometric / rational dynamics
around it.

Every operation is a sound over-approximation; division needs a
sign-definite denominator.  ``iv_dot``'s products must run in float32: under
TF32 the enclosure is no longer sound, so certification runs inside
``verify.certify.float32_matmuls()``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

__all__ = ["IV", "iv", "iv_dot"]


class IV(NamedTuple):
    lo: torch.Tensor
    hi: torch.Tensor

    # -- arithmetic ----------------------------------------------------------

    def __add__(self, o):
        if isinstance(o, IV):
            return IV(self.lo + o.lo, self.hi + o.hi)
        return IV(self.lo + o, self.hi + o)

    __radd__ = __add__

    def __neg__(self):
        return IV(-self.hi, -self.lo)

    def __sub__(self, o):
        return self + (-o)

    def __rsub__(self, o):
        return (-self) + o

    def __mul__(self, o):
        if not isinstance(o, IV):
            o = IV(o, o)
        cands = torch.stack(torch.broadcast_tensors(
            self.lo * o.lo, self.lo * o.hi, self.hi * o.lo, self.hi * o.hi))
        return IV(cands.amin(0), cands.amax(0))

    __rmul__ = __mul__

    def recip(self):
        """1/x for sign-definite intervals (lo > 0 or hi < 0 everywhere)."""
        return IV(1.0 / self.hi, 1.0 / self.lo)

    def __truediv__(self, o):
        if not isinstance(o, IV):
            # the reciprocal in the tensors' precision, as the JAX version
            # takes it of a float32 scalar
            return self * (1.0 / torch.as_tensor(o, dtype=self.lo.dtype))
        return self * o.recip()

    # -- functions -----------------------------------------------------------

    def sin(self):
        # sound on any interval: the endpoints, clamped where the box holds
        # a peak (x = pi/2 + 2 pi k) or a trough (x = -pi/2 + 2 pi k)
        lo, hi = self.lo, self.hi
        s_lo, s_hi = torch.sin(lo), torch.sin(hi)
        out_lo = torch.minimum(s_lo, s_hi)
        out_hi = torch.maximum(s_lo, s_hi)
        two_pi = 2 * math.pi
        k_max = torch.floor((hi - math.pi / 2) / two_pi) >= torch.ceil(
            (lo - math.pi / 2) / two_pi)
        k_min = torch.floor((hi + math.pi / 2) / two_pi) >= torch.ceil(
            (lo + math.pi / 2) / two_pi)
        out_hi = torch.where(k_max, 1.0, out_hi)
        out_lo = torch.where(k_min, -1.0, out_lo)
        return IV(out_lo, out_hi)

    def cos(self):
        return (self + math.pi / 2).sin()

    def square(self):
        lo2, hi2 = self.lo * self.lo, self.hi * self.hi
        crosses = (self.lo < 0) & (self.hi > 0)
        return IV(torch.where(crosses, 0.0, torch.minimum(lo2, hi2)),
                  torch.maximum(lo2, hi2))

    def contains(self, x, tol=0.0):
        return (x >= self.lo - tol) & (x <= self.hi + tol)

    @property
    def width(self):
        return self.hi - self.lo


def iv(lo, hi=None) -> IV:
    lo = torch.as_tensor(lo)
    return IV(lo, lo if hi is None else torch.as_tensor(hi))


def iv_dot(x: IV, M: torch.Tensor) -> IV:
    """Sound interval image of ``x @ M.T`` for a fixed matrix ``M``.

    Sign-split linear-map interval: each output coordinate attains its
    extremes at per-entry corners chosen by sign(M), not at the two box
    corners ``lo @ M.T`` / ``hi @ M.T``, whose span under-covers whenever a
    row of ``M`` has mixed signs (row [2, -1]: true half-width 3r against a
    corner span of r)."""
    pos = M.clamp_min(0.0)
    neg = M.clamp_max(0.0)
    return IV(x.lo @ pos.T + x.hi @ neg.T, x.hi @ pos.T + x.lo @ neg.T)
