"""Butcher tableau of dopri5 (counterpart of ``fiode_tpu/ode/tableaus.py``).

The numbers are copied from the JAX package, whose ``ode`` package imports
jax; a test holds this copy equal to the JAX one.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["Tableau", "DOPRI5"]


@dataclasses.dataclass(frozen=True)
class Tableau:
    """Explicit RK tableau.  ``err`` = b - b_hat; ``order`` is the exponent
    order of the step-size controller; ``fsal``: the last stage's slope is
    f(t1, y1)."""

    name: str
    order: int
    c: np.ndarray
    a: np.ndarray  # (s, s) strictly lower triangular
    b: np.ndarray  # (s,)
    err: np.ndarray  # (s,)
    fsal: bool


def _dopri5() -> Tableau:
    c = np.array([0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0])
    rows = [
        [1 / 5],
        [3 / 40, 9 / 40],
        [44 / 45, -56 / 15, 32 / 9],
        [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729],
        [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656],
        [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84],
    ]
    a = np.zeros((7, 7))
    for i, r in enumerate(rows):
        a[i + 1, : len(r)] = r
    b = np.array([35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784,
                  11 / 84, 0.0])
    b_hat = np.array([5179 / 57600, 0.0, 7571 / 16695, 393 / 640,
                      -92097 / 339200, 187 / 2100, 1 / 40])
    return Tableau("dopri5", 5, c, a, b, b - b_hat, fsal=True)


DOPRI5 = _dopri5()
