"""The interval QP of a CROWN chunk in one launch (kernel K5).

``fused_cone_qp_bounds(h_lb, h_ub, lb, ub, alpha_1, sigma_1, qp_iters)``
computes what ``verify/ibp_qp.ibp_cbf_qp_band_reference`` computes for the
cone barrier (``with_upper=False``) and ``method="bisect"``: for each cell
and coordinate i the box corners adversarial for f_i's lower and upper
bound, each projected onto {v : sum(v) = 0, v >= lower} by ``qp_iters``
halvings of the dual bracket, and only the diagonal kept.  The plain chain
materialises two (N n, n) float32 tensors and streams them through device
memory in ~550 launches a call; K5 (``csrc/fused_qp.cu``) keeps every row
in registers and reads and writes each cell's 6 n floats once.  It
replaces no Pallas kernel: the JAX package leaves the QP to XLA.

The route (``takes``: ``route`` on a call's ``facts``): K5 for CUDA float32
(N, n) inputs, all four of one shape and contiguous, 1 <= n <= ``MAX_N``,
the barrier constants as numbers, the cone barrier, ``method="bisect"``
and nothing that requires grad.  The plain chain for the CPU, the
two-sided ``with_upper`` branch, the ``exact`` and ``sort`` methods, and
any call in grad mode where an input requires grad (alpha-CROWN's
gradient steps and the refinement's split heuristic differentiate through
the QP; K5 has no backward).

Every launch is counted as ``k5.launches`` (``utils/tracing.py``).  The
source is compiled once per state width n, at first use.
"""
from __future__ import annotations

import ctypes
import functools
import numbers

import torch

from ..utils import tracing
from ._build import load_library

__all__ = ["MAX_N", "route", "facts", "takes", "fused_cone_qp_bounds",
           "build"]

# a thread keeps its cell's 4 n inputs and 2 n brackets in registers (96 of
# them at n = 10); a block stages 128 cells of 4 n floats in 48 KB
MAX_N = 16


def route(device_type: str, dtype: torch.dtype, shaped: bool,
          contiguous: bool, n: int, numbers_given: bool, with_upper: bool,
          method: str, needs_grad: bool) -> bool:
    """True where ``ibp_cbf_qp_band`` launches K5, False where it takes the
    plain chain."""
    return (device_type == "cuda" and dtype == torch.float32 and shaped
            and contiguous and 1 <= n <= MAX_N and numbers_given
            and not with_upper and method == "bisect" and not needs_grad)


def _is_number(x) -> bool:
    return isinstance(x, numbers.Real) and not isinstance(x, bool)


def facts(h_lb: torch.Tensor, h_ub: torch.Tensor, lb: torch.Tensor,
          ub: torch.Tensor, alpha_1, sigma_1, with_upper: bool = False,
          method: str = "bisect") -> tuple:
    """``route``'s arguments for one call of ``ibp_cbf_qp_band``."""
    ts = (h_lb, h_ub, lb, ub)
    shape = tuple(h_lb.shape)
    shaped = len(shape) == 2 and all(tuple(t.shape) == shape for t in ts)
    dtype = h_lb.dtype if all(t.dtype == h_lb.dtype for t in ts) else None
    device = (h_lb.device.type
              if all(t.device == h_lb.device for t in ts) else "mixed")
    needs_grad = torch.is_grad_enabled() and any(t.requires_grad for t in ts)
    return (device, dtype, shaped, all(t.is_contiguous() for t in ts),
            shape[-1] if shape else 0,
            _is_number(alpha_1) and _is_number(sigma_1), with_upper, method,
            needs_grad)


def takes(h_lb, h_ub, lb, ub, alpha_1, sigma_1, with_upper: bool = False,
          method: str = "bisect") -> bool:
    """Whether K5 takes this call of ``ibp_cbf_qp_band``."""
    return route(*facts(h_lb, h_ub, lb, ub, alpha_1, sigma_1, with_upper,
                        method))


def _bind(lib) -> ctypes.CDLL:
    """Declare the C interface of a loaded ``fused_qp`` library."""
    fn = lib.fused_cone_qp_bounds
    fn.argtypes = ([ctypes.c_void_p] * 4
                   + [ctypes.c_float, ctypes.c_float, ctypes.c_int]
                   + [ctypes.c_void_p] * 2 + [ctypes.c_longlong,
                                              ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.fused_qp_width.argtypes = []
    lib.fused_qp_width.restype = ctypes.c_int
    lib.fused_qp_error_string.argtypes = [ctypes.c_int]
    lib.fused_qp_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _lib(n: int):
    lib = _bind(load_library("fused_qp", (("FIODE_QP_N", n),)))
    if lib.fused_qp_width() != n:
        raise RuntimeError(f"fused_qp library built for n = "
                           f"{lib.fused_qp_width()}, the wrapper expects {n}")
    return lib


def build(n: int):
    """Compile (or load) K5 for the state width n."""
    if not 1 <= n <= MAX_N:
        raise ValueError(f"fused_qp: takes 1 <= n <= {MAX_N}, got n = {n}")
    return _lib(n)


def fused_cone_qp_bounds(h_lb: torch.Tensor, h_ub: torch.Tensor,
                         lb: torch.Tensor, ub: torch.Tensor, alpha_1: float,
                         sigma_1: float, qp_iters: int = 30):
    """(f_lb, f_ub), each (N, n): the bounds of the cone-projected dynamics
    over the box [h_lb, h_ub] with raw bounds [lb, ub], by one launch of K5
    (arguments and result as ``ibp_cbf_qp_band`` with ``with_upper=False``
    and ``method="bisect"``).  Raises ``ValueError`` on what K5 does not
    take: inputs not CUDA float32 contiguous (N, n) of one shape, n past
    ``MAX_N``, constants that are not numbers, a negative ``qp_iters``, or
    an input that requires grad in grad mode."""
    dev, dtype, shaped, contiguous, n, given, _, _, needs_grad = facts(
        h_lb, h_ub, lb, ub, alpha_1, sigma_1)
    if dtype != torch.float32 or not shaped or not contiguous:
        raise ValueError(
            "fused_qp: h_lb, h_ub, lb, ub must be contiguous float32 (N, n) "
            "tensors of one shape, got "
            + ", ".join(f"{t.dtype} {tuple(t.shape)} "
                        f"{'contiguous' if t.is_contiguous() else 'strided'}"
                        for t in (h_lb, h_ub, lb, ub)))
    if not 1 <= n <= MAX_N:
        raise ValueError(f"fused_qp: takes 1 <= n <= {MAX_N}, got n = {n}")
    if not given:
        raise ValueError("fused_qp: alpha_1 and sigma_1 must be numbers")
    if needs_grad:
        raise ValueError("fused_qp: K5 has no backward; an input requires "
                         "grad")
    if qp_iters < 0:
        raise ValueError(f"fused_qp: qp_iters must be >= 0, got {qp_iters}")
    if dev != "cuda":
        raise ValueError(f"fused_qp: unsupported device {h_lb.device}")
    lib = build(n)
    N = h_lb.shape[0]
    f_lb = torch.empty((N, n), device=h_lb.device, dtype=torch.float32)
    f_ub = torch.empty_like(f_lb)
    rc = lib.fused_cone_qp_bounds(
        h_lb.data_ptr(), h_ub.data_ptr(), lb.data_ptr(), ub.data_ptr(),
        float(alpha_1), float(sigma_1), int(qp_iters), f_lb.data_ptr(),
        f_ub.data_ptr(), N, torch.cuda.current_stream(h_lb.device).cuda_stream)
    if rc != 0:
        msg = lib.fused_qp_error_string(rc).decode()
        raise RuntimeError(f"fused_qp kernel failed: {msg}")
    tracing.count("k5.launches")
    return f_lb, f_ub
