"""Fused CROWN bounds of the three-layer ReLU dynamics twin (kernel K4).

``fused_crown_bounds(Ws, bs, eta0, eps, x_bias, alphas)`` computes what
``verify/crown.crown_bounds_reference`` computes for Ws = [W1, W2, W3] with
m2 >= n (the dynamics twin f = W3 relu(W2 relu(W1 eta + x_bias + b1) + b2)
+ b3 bounded over the eta box), in one launch of ``csrc/fused_crown.cu``
that keeps every per-row linear form on the chip and writes only
(lb, ub).  The plain chain makes (rows, n, mlp) float32 intermediates in
layers 2 and 3 and streams each through device memory several times; K4
is bound by its arithmetic instead (~1.4 MFLOP a row at the flagship
counted dense, in fp32 FFMA), and runs each product only over a row's
neurons that add to it.  It replaces no Pallas kernel: the JAX package
leaves CROWN to XLA.

The route (``takes``: ``route`` on a call's ``facts``): K4 for CUDA
float32 inputs of three layers with m2 >= n, a scalar or a per-row (N, n)
eps, and alpha-CROWN slopes that need no gradient.  The plain path for CPU
tensors, any other depth (the Segway controller has two layers), m2 < n,
and any call in grad mode where an input requires grad (alpha-CROWN's
gradient steps: K4 has no backward).  A shape K4 takes by the route but
whose block would not fit (``shared_memory_bytes``, ``accumulators``) is
refused with a ``ValueError`` before any build or launch.

Every launch is counted as ``k4.launches`` (``utils/tracing.py``).  The
source is compiled once per shape (n, m1, m2, out), at first use.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence

import torch

from ..utils import tracing
from ._build import load_library

__all__ = ["LANES", "PASS", "SMEM_LIMIT", "MAX_ACCUMULATORS", "rows",
           "shared_memory_bytes", "accumulators", "check_domain",
           "layer3_columns", "route", "facts", "takes", "fused_crown_bounds",
           "build"]

LANES = 16    # threads of a row; thread t owns columns t, t + 16, ...
PASS = 8      # layer 3: columns of layer 1's list a lane takes in a pass
SMEM_LIMIT = 232448       # dynamic shared memory a block may have on sm_90
MAX_ACCUMULATORS = 176    # sums a thread keeps in 255 registers: the flagship's


def _cols(m: int) -> int:
    """Columns a thread owns of a layer of width m."""
    return -(-m // LANES)


def accumulators(n: int, m1: int, m2: int, out: int) -> int:
    """Registers a thread sums into: layer 2's S, D (n each) and s, d of
    its m2 columns, or layer 3's two forms (out each) of a pass's columns
    of layer 1's list (at most PASS)."""
    return max((2 * n + 2) * _cols(m2), 2 * out * min(PASS, _cols(m1)))


def _layout(n: int, m1: int, m2: int, out: int) -> tuple:
    """(floats of the weights, floats a row) of ``csrc/fused_crown.cu``'s
    shared memory: W3^T at a row stride of out rounded up to 4, W1 at an
    odd multiple of 4 floats, W2 at the odd row stride m1p + 1, the biases;
    per row layer 1's float4 stage, layer 2's float2 stage, the 2 out x
    (n + 1) slots of layer 3's sums, the four lists of neurons (16-bit) and
    their lengths, eta, eps and layer 3's bias terms."""
    m1p, m2p = LANES * _cols(m1), LANES * _cols(m2)
    s1 = -(-n // 4) * 4
    s1 += 4 * (s1 // 4 % 2 == 0)
    s3 = -(-out // 4) * 4
    weights = m2p * s3 + m1p * s1 + m2p * (m1p + 1) + m1p + m2p + out
    per_row = (4 * m1p + 2 * m2p + 2 * out * (n + 1) + (m1p + m2p) + 4
               + 2 * n + 2 * out)
    return weights, per_row


def _fits(n: int, m1: int, m2: int, out: int, r: int) -> bool:
    weights, per_row = _layout(n, m1, m2, out)
    return 4 * (r * per_row + weights) <= SMEM_LIMIT


@functools.lru_cache(maxsize=64)
def rows(n: int, m1: int, m2: int, out: int) -> int:
    """Rows of K4's block: 16, or the most of 8, 4, 2 that fit in shared
    memory (2 where nothing fits: ``check_domain`` refuses it)."""
    return next((r for r in (16, 8, 4) if _fits(n, m1, m2, out, r)), 2)


def shared_memory_bytes(n: int, m1: int, m2: int, out: int) -> int:
    """Shared memory of one block of K4, as ``csrc/fused_crown.cu`` lays it
    out for ``rows(n, m1, m2, out)`` rows."""
    weights, per_row = _layout(n, m1, m2, out)
    return 4 * (rows(n, m1, m2, out) * per_row + weights)


def check_domain(n: int, m1: int, m2: int, out: int) -> None:
    """Refuse, before the build and the launch, a shape whose block does not
    fit in shared memory or whose sums would not stay in registers."""
    need = shared_memory_bytes(n, m1, m2, out)
    if need > SMEM_LIMIT:
        raise ValueError(
            f"fused_crown: n = {n}, m1 = {m1}, m2 = {m2}, out = {out} needs "
            f"{need} bytes of shared memory per block, more than the "
            f"{SMEM_LIMIT} a block can have")
    acc = accumulators(n, m1, m2, out)
    if acc > MAX_ACCUMULATORS:
        raise ValueError(
            f"fused_crown: n = {n}, m1 = {m1}, m2 = {m2}, out = {out} sums "
            f"into {acc} registers a thread, more than the "
            f"{MAX_ACCUMULATORS} K4 keeps without spilling")


def layer3_columns(l1: torch.Tensor, u1: torch.Tensor) -> torch.Tensor:
    """(N,) the columns layer 3 of K4 runs over for each row: its layer-1
    neurons not off on the box, from their pre-activation bounds l1, u1
    (N, m1).  A neuron is off (zero slopes and lines) where u1 <= 0 < -l1;
    stable on (l1 >= 0) or unstable (l1 < 0 < u1) it has a positive upper
    slope.  A row's list takes ceil(count / (16 PASS)) passes; a warp takes
    those of the longer of its two rows."""
    return ((u1 > 0) | (l1 >= 0)).sum(-1)


def route(device_type: str, dtype: torch.dtype, layers: int, n: int, m2: int,
          needs_grad: bool) -> bool:
    """True where ``crown_mlp_bounds`` launches K4, False where it takes the
    plain path: K4 takes CUDA float32 three-layer stacks with m2 >= n and
    no gradient to carry."""
    return (device_type == "cuda" and dtype == torch.float32 and layers == 3
            and m2 >= n and not needs_grad)


def facts(Ws: Sequence[torch.Tensor], bs: Sequence[torch.Tensor],
          eta0: torch.Tensor, eps, x_bias: torch.Tensor,
          alphas: Optional[Sequence[torch.Tensor]] = None) -> tuple:
    """``route``'s arguments for one call of ``crown_mlp_bounds``."""
    inputs = [*Ws, *bs, eta0, x_bias, *(alphas or ())]
    if isinstance(eps, torch.Tensor):
        inputs.append(eps)
    needs_grad = torch.is_grad_enabled() and any(t.requires_grad
                                                 for t in inputs)
    m2 = Ws[1].shape[0] if len(Ws) > 1 else 0
    return (eta0.device.type, eta0.dtype, len(Ws), eta0.shape[-1], m2,
            needs_grad)


def takes(Ws: Sequence[torch.Tensor], bs: Sequence[torch.Tensor],
          eta0: torch.Tensor, eps, x_bias: torch.Tensor,
          alphas: Optional[Sequence[torch.Tensor]] = None) -> bool:
    """Whether K4 takes this call of ``crown_mlp_bounds``."""
    return route(*facts(Ws, bs, eta0, eps, x_bias, alphas))


def _bind(lib) -> ctypes.CDLL:
    """Declare the C interface of a loaded ``fused_crown`` library."""
    fn = lib.fused_crown_bounds
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_float, ctypes.c_void_p,
                                            ctypes.c_longlong]
                   + [ctypes.c_void_p] * 4 + [ctypes.c_longlong,
                                              ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.fused_crown_shape.argtypes = [ctypes.c_int]
    lib.fused_crown_shape.restype = ctypes.c_int
    lib.fused_crown_smem_bytes.argtypes = []
    lib.fused_crown_smem_bytes.restype = ctypes.c_longlong
    lib.fused_crown_smem_limit.argtypes = []
    lib.fused_crown_smem_limit.restype = ctypes.c_longlong
    lib.fused_crown_rows.argtypes = []
    lib.fused_crown_rows.restype = ctypes.c_int
    lib.fused_crown_error_string.argtypes = [ctypes.c_int]
    lib.fused_crown_error_string.restype = ctypes.c_char_p
    # the source and this module lay out shared memory independently
    n, m1, m2, out = (lib.fused_crown_shape(i) for i in range(4))
    got = (lib.fused_crown_smem_bytes(), lib.fused_crown_smem_limit(),
           lib.fused_crown_rows())
    want = (shared_memory_bytes(n, m1, m2, out), SMEM_LIMIT,
            rows(n, m1, m2, out))
    if got != want:
        raise RuntimeError(f"fused_crown library for {(n, m1, m2, out)} "
                           f"takes {got} bytes of shared memory (limit, "
                           f"rows a block), the wrapper expects {want}")
    return lib


@functools.cache
def _lib(n: int, m1: int, m2: int, out: int):
    lib = _bind(load_library("fused_crown", (("FIODE_CROWN_N", n),
                                            ("FIODE_CROWN_M1", m1),
                                            ("FIODE_CROWN_M2", m2),
                                            ("FIODE_CROWN_OUT", out))))
    got = tuple(lib.fused_crown_shape(i) for i in range(4))
    if got != (n, m1, m2, out):
        raise RuntimeError(f"fused_crown library built for {got}, the wrapper "
                           f"expects {(n, m1, m2, out)}")
    return lib


def build(n: int, m1: int, m2: int, out: int):
    """Compile (or load) K4 for the shape (n, m1, m2, out)."""
    check_domain(n, m1, m2, out)
    return _lib(n, m1, m2, out)


def _check(name, t, shape, device):
    if (t.device != device or t.dtype != torch.float32
            or tuple(t.shape) != shape):
        raise ValueError(f"fused_crown: {name} must be a float32 {shape} "
                         f"tensor on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def _on(name, t, shape, device):
    _check(name, t, shape, device)
    return t.contiguous()


def fused_crown_bounds(Ws: Sequence[torch.Tensor], bs: Sequence[torch.Tensor],
                       eta0: torch.Tensor, eps, x_bias: torch.Tensor,
                       alphas: Optional[Sequence[torch.Tensor]] = None):
    """(lb, ub), each (N, out), of the three-layer stack over the eta box, by
    one launch of K4.  Arguments as ``verify/crown.crown_mlp_bounds``:
    eps a number (or 0-dim tensor) or (N, n) per-row half-widths; x_bias (m1,)
    or (N, m1), read with its row stride; alphas None or one tensor per
    hidden layer, broadcastable to (N, m_j)."""
    if len(Ws) != 3 or len(bs) != 3:
        raise ValueError(f"fused_crown: takes three layers, got {len(Ws)}")
    dev = eta0.device
    if dev.type != "cuda":
        raise ValueError(f"fused_crown: unsupported device {dev}")
    N, n = eta0.shape
    m1, m2, out = Ws[0].shape[0], Ws[1].shape[0], Ws[2].shape[0]
    if m2 < n:
        raise ValueError(f"fused_crown: takes m2 >= n, got m2 = {m2}, n = {n}")
    check_domain(n, m1, m2, out)
    W = [_on(f"W{j + 1}", w, s, dev)
         for j, (w, s) in enumerate(zip(Ws, ((m1, n), (m2, m1), (out, m2))))]
    b = [_on(f"b{j + 1}", v, (s,), dev)
         for j, (v, s) in enumerate(zip(bs, (m1, m2, out)))]
    eta0 = _on("eta0", eta0, (N, n), dev)
    # x_bias is read with its row stride (0 where it is one shared row)
    xb = x_bias.expand(N, m1) if x_bias.dim() == 1 else x_bias
    _check("x_bias", xb, (N, m1), dev)
    if xb.stride(1) != 1:
        xb = xb.contiguous()
    eps_rows, eps_scalar = None, 0.0
    if isinstance(eps, torch.Tensor) and eps.dim() > 0:
        eps_rows = _on("eps", eps, (N, n), dev)
    else:
        eps_scalar = float(eps)
    a1 = a2 = None
    if alphas is not None:
        a1 = _on("alphas[0]", alphas[0].expand(N, m1), (N, m1), dev)
        a2 = _on("alphas[1]", alphas[1].expand(N, m2), (N, m2), dev)
    lib = build(n, m1, m2, out)
    lb = torch.empty((N, out), device=dev, dtype=torch.float32)
    ub = torch.empty_like(lb)
    rc = lib.fused_crown_bounds(
        *(t.data_ptr() for t in (W[0], b[0], W[1], b[1], W[2], b[2], eta0)),
        None if eps_rows is None else eps_rows.data_ptr(), eps_scalar,
        xb.data_ptr(), xb.stride(0),
        None if a1 is None else a1.data_ptr(),
        None if a2 is None else a2.data_ptr(),
        lb.data_ptr(), ub.data_ptr(), N,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        msg = lib.fused_crown_error_string(rc).decode()
        raise RuntimeError(f"fused_crown kernel failed: {msg}")
    tracing.count("k4.launches")
    return lb, ub
