"""Fused Fourier-domain orthogonal convolution (counterpart of
``fiode_tpu/ops/fused_cayley_conv.py``).

``fused_freq_apply(x, Qr, Qi)`` has the semantics of
``apply_freq_matrices(x, Qr + i Qi, impl="dft")``: forward rDFT, one complex
(co, ci) matrix per frequency, inverse rDFT.  On a CPU tensor it runs that
plain dense-DFT version; on a CUDA tensor it launches kernel K3
(``csrc/fused_cayley_conv.cu``: forward transform, per-frequency mix as a
batched GEMM with the images as rows, inverse transform; three CUDA launches
counted as one apply).  It takes every spatial size n: radix-2 transforms
for n = 8, 16 and 32, direct ones for any other n, through device memory
where a plane does not fit in one block's shared memory (n > 169).  The
wrapper builds the twiddle table the transforms read (``twiddle_table``),
the frequency-major scratch X (2, F, B ci) and Y (2, F, B co), and the
scratch of the transforms through device memory where they need it.

Backward on CUDA: the map is linear in x, and its VJP is the transposed
frequency application, dx = apply(g, Q^H) with Q^H the conjugate transpose
of each frequency's matrix: the dense rDFT and its inverse are adjoint up to
a per-frequency weight that commutes with Q.  So dx is one more K3 apply,
reading Q through swapped strides with its imaginary part negated (no copy
of Q^H).  The JAX package has no backward kernel either (its VJP is
the jnp reference path); dQ, needed only when Q requires grad (training),
goes through the VJP of the plain dense-DFT version, as in JAX.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ._build import load_library
from .cayley import apply_freq_matrices

__all__ = ["fused_freq_apply", "twiddle_table", "is_radix"]


@functools.cache
def _lib():
    lib = load_library("fused_cayley_conv")
    fn = lib.fused_freq_apply_forward
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 3
                   + [ctypes.c_float, ctypes.c_int] + [ctypes.c_void_p] * 5
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.fused_freq_apply_tmp_floats.argtypes = [ctypes.c_int] * 4
    lib.fused_freq_apply_tmp_floats.restype = ctypes.c_longlong
    lib.fused_cayley_conv_error_string.argtypes = [ctypes.c_int]
    lib.fused_cayley_conv_error_string.restype = ctypes.c_char_p
    return lib


def is_radix(n: int) -> bool:
    """Whether K3's transforms at spatial size n take the radix-2 passes
    (the flagship's 32, 16 and 8); any other n takes the direct passes."""
    return n in (8, 16, 32)


@functools.lru_cache(maxsize=16)
def twiddle_table(n: int) -> np.ndarray:
    """The table K3's transforms read, float32 (2, L), computed in float64.

    Radix passes: L = n - 1 stage twiddles; entry h - 1 + j (j < h) of
    stage h = 1, 2, ..., n / 2 is cos (row 0) and sin (row 1) of pi j / h.
    Direct passes: L = n, cos and sin of 2 pi k / n."""
    if is_radix(n):
        ang = np.concatenate([np.pi * np.arange(h) / h
                              for h in 2 ** np.arange(n.bit_length() - 1)])
    else:
        ang = 2.0 * np.pi * np.arange(n) / n
    return np.stack([np.cos(ang), np.sin(ang)]).astype(np.float32)


@functools.lru_cache(maxsize=32)
def _table_on(n: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(twiddle_table(n)).to(device)


def _launch(x, Qr, Qi, adjoint=False):
    """K3 on x with the matrices Q (F, co, ci) = Qr + i Qi, or with their
    conjugate transposes when ``adjoint`` (x then has co channels)."""
    B, cin, n, n2 = x.shape
    F, a, b = Qr.shape
    k, cout = (a, b) if adjoint else (b, a)
    if (n2 != n or F != n * (n // 2 + 1) or k != cin
            or Qi.shape != Qr.shape):
        raise ValueError(
            f"fused_freq_apply: x {tuple(x.shape)} and Q {tuple(Qr.shape)} "
            f"(adjoint={adjoint}) do not match (need square x and "
            f"F = n * (n // 2 + 1))"
        )
    for name, t in (("x", x), ("Qr", Qr), ("Qi", Qi)):
        if t.device != x.device or t.dtype != torch.float32:
            raise ValueError(
                f"fused_freq_apply: {name} must be float32 on {x.device}, "
                f"got {t.dtype} on {t.device}"
            )
    x = x.contiguous()
    if x.data_ptr() % 16:  # the forward transform loads x 16 bytes at a time
        x = x.clone()
    Qr, Qi = Qr.contiguous(), Qi.contiguous()
    # element (q, o, c) of the applied matrix: Q[q, o, c] or conj Q[q, c, o]
    so, sc = (1, b) if adjoint else (b, 1)
    dev = x.device
    xf = torch.empty((2, F, B * cin), device=dev, dtype=torch.float32)
    yf = torch.empty((2, F, B * cout), device=dev, dtype=torch.float32)
    out = torch.empty((B, cout, n, n), device=dev, dtype=torch.float32)
    lib = _lib()
    # the transforms through device memory (planes past shared memory)
    n_tmp = lib.fused_freq_apply_tmp_floats(B, cin, cout, n)
    tmp = torch.empty(n_tmp, device=dev, dtype=torch.float32) if n_tmp else None
    rc = lib.fused_freq_apply_forward(
        x.data_ptr(), Qr.data_ptr(), Qi.data_ptr(), a * b, so, sc,
        -1.0 if adjoint else 1.0, int(is_radix(n)),
        _table_on(n, dev).data_ptr(), xf.data_ptr(), yf.data_ptr(),
        None if tmp is None else tmp.data_ptr(), out.data_ptr(), B, cin, cout, n,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        msg = lib.fused_cayley_conv_error_string(rc).decode()
        raise RuntimeError(f"fused_freq_apply kernel failed: {msg}")
    fused_freq_apply.launches += 1
    return out


class _FusedFreqApplyCuda(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, Qr, Qi):
        ctx.save_for_backward(x, Qr, Qi)
        return _launch(x, Qr, Qi)

    @staticmethod
    def backward(ctx, g):
        x, Qr, Qi = ctx.saved_tensors
        dx = dQr = dQi = None
        if ctx.needs_input_grad[0]:
            # K3 on Q^H: the output has ci channels
            dx = _launch(g.contiguous(), Qr, Qi, adjoint=True)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            with torch.enable_grad():
                qr = Qr.detach().requires_grad_()
                qi = Qi.detach().requires_grad_()
                y = apply_freq_matrices(x, torch.complex(qr, qi), impl="dft")
                dQr, dQi = torch.autograd.grad(y, (qr, qi), g)
        return dx, dQr, dQi


def fused_freq_apply(x: torch.Tensor, Qr: torch.Tensor,
                     Qi: torch.Tensor) -> torch.Tensor:
    """Orthogonal conv apply: x (B, ci, n, n), Qr/Qi (F, co, ci) float32 ->
    (B, co, n, n).

    A CPU tensor takes the plain dense-DFT version; a CUDA tensor launches
    K3 (and adds one to ``fused_freq_apply.launches``) or raises.  On CUDA
    the backward in x launches K3 once more, on Q^H (and counts it).
    """
    if x.device.type == "cpu":
        return apply_freq_matrices(x, torch.complex(Qr, Qi), impl="dft")
    if x.device.type != "cuda":
        raise ValueError(f"fused_freq_apply: unsupported device {x.device}")
    return _FusedFreqApplyCuda.apply(x, Qr, Qi)


fused_freq_apply.launches = 0
