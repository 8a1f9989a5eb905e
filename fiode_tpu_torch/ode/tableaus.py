"""Explicit Runge-Kutta Butcher tableaus (counterpart of
``fiode_tpu/ode/tableaus.py``).

  adaptive: dopri5, dopri8, bosh3, fehlberg2, adaptive_heun
  fixed:    euler, midpoint, rk4, explicit_adams, implicit_adams, fixed_adams
            (the Adams forms step with rk4 until their history is full)

``dopri8`` is DOP853, read from scipy's ``dop853_coefficients`` as the JAX
package reads it, with one stage appended at t1 (its row is b) so that the
last slope is f(t1, y1), and the combined 5th / 3rd order error estimate.
The other numbers are copied from the JAX package, whose ``ode`` package
imports jax; a test holds every array equal to the JAX one.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

__all__ = ["Tableau", "DOPRI5", "get_tableau", "ADAPTIVE_SOLVERS",
           "FIXED_SOLVERS"]

ADAPTIVE_SOLVERS = ("dopri5", "dopri8", "bosh3", "fehlberg2", "adaptive_heun")
FIXED_SOLVERS = ("euler", "midpoint", "rk4", "explicit_adams",
                 "implicit_adams", "fixed_adams")


@dataclasses.dataclass(frozen=True)
class Tableau:
    """Explicit RK tableau.  ``err`` = b - b_hat (None: no embedded
    estimate); ``order`` is the exponent order of the step-size controller;
    ``fsal``: the last stage's slope is f(t1, y1); ``dop853_err``: the error
    is DOP853's combination of the ``err5`` and ``err3`` rows."""

    name: str
    order: int
    c: np.ndarray
    a: np.ndarray  # (s, s) strictly lower triangular
    b: np.ndarray  # (s,)
    err: Optional[np.ndarray]  # (s,)
    fsal: bool = False
    dop853_err: bool = False
    err5: Optional[np.ndarray] = None
    err3: Optional[np.ndarray] = None


def _tri(rows, s):
    a = np.zeros((s, s))
    for i, r in enumerate(rows):
        a[i + 1, : len(r)] = r
    return a


def _dopri5() -> Tableau:
    c = np.array([0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0])
    a = _tri([
        [1 / 5],
        [3 / 40, 9 / 40],
        [44 / 45, -56 / 15, 32 / 9],
        [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729],
        [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656],
        [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84],
    ], 7)
    b = np.array([35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784,
                  11 / 84, 0.0])
    b_hat = np.array([5179 / 57600, 0.0, 7571 / 16695, 393 / 640,
                      -92097 / 339200, 187 / 2100, 1 / 40])
    return Tableau("dopri5", 5, c, a, b, b - b_hat, fsal=True)


def _bosh3() -> Tableau:
    """Bogacki-Shampine 3(2)."""
    c = np.array([0.0, 1 / 2, 3 / 4, 1.0])
    a = _tri([[1 / 2], [0.0, 3 / 4], [2 / 9, 1 / 3, 4 / 9]], 4)
    b = np.array([2 / 9, 1 / 3, 4 / 9, 0.0])
    b_hat = np.array([7 / 24, 1 / 4, 1 / 3, 1 / 8])
    return Tableau("bosh3", 3, c, a, b, b - b_hat, fsal=True)


def _fehlberg2() -> Tableau:
    """Fehlberg 1(2)."""
    c = np.array([0.0, 1 / 2, 1.0])
    a = _tri([[1 / 2], [1 / 256, 255 / 256]], 3)
    b = np.array([1 / 512, 255 / 256, 1 / 512])
    b_hat = np.array([1 / 256, 255 / 256, 0.0])
    return Tableau("fehlberg2", 2, c, a, b, b - b_hat)


def _adaptive_heun() -> Tableau:
    c = np.array([0.0, 1.0])
    a = _tri([[1.0]], 2)
    b = np.array([1 / 2, 1 / 2])
    b_hat = np.array([1.0, 0.0])
    return Tableau("adaptive_heun", 2, c, a, b, b - b_hat)


def _dopri8() -> Tableau:
    from scipy.integrate._ivp import dop853_coefficients as dc

    s = dc.N_STAGES  # 12
    a = np.zeros((s + 1, s + 1))
    a[:s, :s] = dc.A[:s, :s]
    a[s, :s] = dc.B  # the appended stage at t1: its slope is f(t1, y1)
    c = np.concatenate([dc.C[:s], [1.0]])
    b = np.concatenate([dc.B, [0.0]])
    # scipy's E rows carry a last entry weighting f(t1, y1): the appended
    # stage's
    err5 = np.asarray(dc.E5, dtype=np.float64).copy()
    err3 = np.asarray(dc.E3, dtype=np.float64).copy()
    return Tableau("dopri8", 8, c, a, b, None, fsal=True, dop853_err=True,
                   err5=err5, err3=err3)


def _euler() -> Tableau:
    return Tableau("euler", 1, np.array([0.0]), np.zeros((1, 1)),
                   np.array([1.0]), None)


def _midpoint() -> Tableau:
    return Tableau("midpoint", 2, np.array([0.0, 1 / 2]), _tri([[1 / 2]], 2),
                   np.array([0.0, 1.0]), None)


def _rk4() -> Tableau:
    c = np.array([0.0, 1 / 2, 1 / 2, 1.0])
    a = _tri([[1 / 2], [0.0, 1 / 2], [0.0, 0.0, 1.0]], 4)
    b = np.array([1 / 6, 1 / 3, 1 / 3, 1 / 6])
    return Tableau("rk4", 4, c, a, b, None)


_TABLEAUS = {
    "dopri5": _dopri5,
    "dopri8": _dopri8,
    "bosh3": _bosh3,
    "fehlberg2": _fehlberg2,
    "adaptive_heun": _adaptive_heun,
    "euler": _euler,
    "midpoint": _midpoint,
    "rk4": _rk4,
}


def get_tableau(name: str) -> Tableau:
    """The tableau of an RK method by name; ``ValueError`` for any other."""
    try:
        return _TABLEAUS[name]()
    except KeyError:
        raise ValueError(
            f"Unknown RK method {name!r}; available: {sorted(_TABLEAUS)}"
        ) from None


DOPRI5 = _dopri5()
