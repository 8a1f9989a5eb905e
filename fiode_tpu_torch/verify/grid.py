"""Decision-boundary grid: enumeration of the T-lattice on the simplex
(counterpart of ``fiode_tpu/verify/grid.py``).

The verification sweep evaluates the Lyapunov decrease condition on every
lattice point h in (Z/T)^n with sum(h) = 1 and h_label == max wrong prob.
Coordinate 0 plays the label here; ``grid_for_label`` swaps it into place.

The enumeration core is C++ (``csrc/grid_enum.cpp``), built with ``g++ -O3``
at first use into ``build/fiode_tpu_torch/`` and loaded over ctypes.  A build
that fails raises.  ``impl="python"`` asks for the pure-Python enumeration,
the plain version the tests hold the native one against; it is never taken
silently (the full n = 10, T = 40 grid has 41,320,837 rows and would take
hours that way).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np

from ..ops._build import load_cpp_library

__all__ = [
    "count_decision_boundary",
    "enumerate_decision_boundary",
    "grid_for_label",
]


@functools.cache
def _native() -> ctypes.CDLL:
    lib = load_cpp_library("grid_enum")
    lib.count_boundary.restype = ctypes.c_int64
    lib.count_boundary.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.enum_boundary.restype = ctypes.c_int64
    lib.enum_boundary.argtypes = [ctypes.c_int, ctypes.c_int,
                                  ctypes.POINTER(ctypes.c_int16)]
    return lib


def _count_py(n: int, T: int) -> int:
    """Counting oracle: sum over the tied max m of
    #(bounded compositions of T-m into n-1 parts with max exactly m)."""

    @functools.lru_cache(maxsize=None)
    def comps_le(k: int, s: int, m: int) -> int:
        if s < 0 or m * k < s:
            return 0
        if k == 0:
            return 1 if s == 0 else 0
        return sum(comps_le(k - 1, s - v, m) for v in range(min(m, s) + 1))

    total = 0
    for m in range(T + 1):
        le_m = comps_le(n - 1, T - m, m)
        le_m1 = comps_le(n - 1, T - m, m - 1) if m > 0 else 0
        total += le_m - le_m1
    return total


def _enum_py(n: int, T: int) -> np.ndarray:
    """Integer lattice rows (count, n) int16, in the native order."""
    rows = []
    cur = np.zeros(n, np.int16)

    def rec(pos, remaining, m, used_m):
        left = n - pos
        if left == 0:
            if remaining == 0 and used_m:
                rows.append(cur.copy())
            return
        if remaining < 0 or m * left < remaining:
            return
        if not used_m and remaining < m:
            return
        for v in range(min(m, remaining) + 1):
            cur[pos] = v
            rec(pos + 1, remaining - v, m, used_m or v == m)
        cur[pos] = 0

    for m in range(T + 1):
        cur[0] = m
        rec(1, T - m, m, False)
    return np.stack(rows) if rows else np.zeros((0, n), np.int16)


def _check_impl(impl: str) -> None:
    if impl not in ("native", "python"):
        raise ValueError(f"impl must be 'native' or 'python', got {impl!r}")


def count_decision_boundary(n: int = 10, T: int = 40,
                            impl: str = "native") -> int:
    _check_impl(impl)
    if impl == "python":
        return _count_py(n, T)
    return int(_native().count_boundary(n, T))


def enumerate_decision_boundary(n: int = 10, T: int = 40,
                                impl: str = "native") -> np.ndarray:
    """All lattice points, float32 (count, n), coordinates summing to 1,
    with coordinate 0 playing the label role (tied max)."""
    _check_impl(impl)
    if impl == "python":
        grid = _enum_py(n, T)
    else:
        lib = _native()
        cnt = int(lib.count_boundary(n, T))
        grid = np.zeros((cnt, n), np.int16)
        written = lib.enum_boundary(
            n, T, grid.ctypes.data_as(ctypes.POINTER(ctypes.c_int16))
        )
        if written != cnt:
            raise RuntimeError(f"grid_enum wrote {written} rows, counted {cnt}")
    return grid.astype(np.float32) / T


def grid_for_label(grid: np.ndarray, label: int) -> np.ndarray:
    """Swap coordinate 0 with ``label``."""
    g = grid.copy()
    if label != 0:
        g[:, [label, 0]] = g[:, [0, label]]
    return g
