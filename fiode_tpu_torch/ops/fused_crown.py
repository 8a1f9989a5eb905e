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

__all__ = ["ROWS", "LANES", "SMEM_LIMIT", "MAX_ACCUMULATORS",
           "shared_memory_bytes", "accumulators", "check_domain", "route",
           "facts", "takes", "fused_crown_bounds", "build"]

ROWS = 16     # rows of a block's tile
LANES = 16    # threads of a row; thread t owns columns t, t + 16, ...
SMEM_LIMIT = 232448       # dynamic shared memory a block may have on sm_90
MAX_ACCUMULATORS = 176    # sums a thread keeps in its 255 registers: the flagship's


def _cols(m: int) -> int:
    """Columns a thread owns of a layer of width m."""
    return -(-m // LANES)


@functools.lru_cache(maxsize=64)
def shared_memory_bytes(n: int, m1: int, m2: int, out: int) -> int:
    """Shared memory of one block of K4, as ``csrc/fused_crown.cu`` lays it
    out: per row, layer 1's two float4 stages (the first one reused by
    layer 2's float4 stage), layer 2's float2 stage, the lists of neurons
    (16-bit) and their four lengths, eta, eps and layer 3's bias terms; W3^T
    and |W3|^T at a row stride of out rounded up to 4, W1 at an odd
    multiple of 4 floats, W2 at the odd row stride m1p + 1, the biases."""
    m1p, m2p = LANES * _cols(m1), LANES * _cols(m2)
    s1 = -(-n // 4) * 4
    s1 += 4 * (s1 // 4 % 2 == 0)
    s3 = -(-out // 4) * 4
    per_row = (4 * max(m1p, m2p) + 4 * m1p + 2 * m2p + (m1p + m2p) + 4
               + 2 * n + 2 * out)
    floats = (ROWS * per_row + 2 * m2p * s3 + m1p * s1 + m2p * (m1p + 1)
              + m1p + m2p + out)
    return 4 * floats


def accumulators(n: int, m1: int, m2: int, out: int) -> int:
    """Registers a thread sums into: layer 2's S, D (n each) and s, d of
    its m2 columns, or layer 3's two forms (out each) of its m1 columns."""
    return max((2 * n + 2) * _cols(m2), 2 * out * _cols(m1))


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
    lib.fused_crown_error_string.argtypes = [ctypes.c_int]
    lib.fused_crown_error_string.restype = ctypes.c_char_p
    # the source and this module lay out shared memory independently
    n, m1, m2, out = (lib.fused_crown_shape(i) for i in range(4))
    got = (lib.fused_crown_smem_bytes(), lib.fused_crown_smem_limit())
    want = (shared_memory_bytes(n, m1, m2, out), SMEM_LIMIT)
    if got != want:
        raise RuntimeError(f"fused_crown library for {(n, m1, m2, out)} "
                           f"takes {got} bytes of shared memory (and "
                           f"limit), the wrapper expects {want}")
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
