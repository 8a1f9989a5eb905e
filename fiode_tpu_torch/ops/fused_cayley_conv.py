"""Fused Fourier-domain orthogonal convolution (counterpart of
``fiode_tpu/ops/fused_cayley_conv.py``).

``fused_freq_apply(x, Qr, Qi)`` has the semantics of
``apply_freq_matrices(x, Qr + i Qi, impl="dft")``: forward rDFT, one complex
(co, ci) matrix per frequency, inverse rDFT.  On a CPU tensor it runs that
plain dense-DFT version; on a CUDA tensor it launches kernel K3
(``csrc/fused_cayley_conv.cu``, two launches).

Backward on CUDA: the map is linear in x, and its VJP is the transposed
frequency application, dx = apply(g, Q^H) with Q^H the conjugate transpose
of each frequency's matrix: the dense rDFT and its inverse are adjoint up to
a per-frequency weight that commutes with Q.  So dx is one more K3 launch on
(g, Qr^T, -Qi^T).  The JAX package has no backward kernel either (its VJP is
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

__all__ = ["fused_freq_apply"]


@functools.cache
def _lib():
    lib = load_library("fused_cayley_conv")
    fn = lib.fused_freq_apply_forward
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.fused_cayley_conv_error_string.argtypes = [ctypes.c_int]
    lib.fused_cayley_conv_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=16)
def _twiddles(n: int, device: torch.device) -> torch.Tensor:
    """(2, n) float32: cos and sin of 2 pi k / n, computed in float64."""
    ang = 2.0 * np.pi * np.arange(n) / n
    tw = np.stack([np.cos(ang), np.sin(ang)]).astype(np.float32)
    return torch.from_numpy(tw).to(device)


def _launch(x, Qr, Qi):
    B, ci, n, n2 = x.shape
    F, co, ci_q = Qr.shape
    if n2 != n or F != n * (n // 2 + 1) or ci_q != ci or Qi.shape != Qr.shape:
        raise ValueError(
            f"fused_freq_apply: x {tuple(x.shape)} and Q {tuple(Qr.shape)} "
            f"do not match (need square x and F = n * (n // 2 + 1))"
        )
    for name, t in (("x", x), ("Qr", Qr), ("Qi", Qi)):
        if t.device != x.device or t.dtype != torch.float32:
            raise ValueError(
                f"fused_freq_apply: {name} must be float32 on {x.device}, "
                f"got {t.dtype} on {t.device}"
            )
    x = x.contiguous()
    # (F, ci, co): lanes of a warp read neighbouring output channels
    qr = Qr.transpose(1, 2).contiguous()
    qi = Qi.transpose(1, 2).contiguous()
    yr = torch.empty((B, F, co), device=x.device, dtype=torch.float32)
    yi = torch.empty_like(yr)
    out = torch.empty((B, co, n, n), device=x.device, dtype=torch.float32)
    lib = _lib()
    rc = lib.fused_freq_apply_forward(
        x.data_ptr(), qr.data_ptr(), qi.data_ptr(),
        _twiddles(n, x.device).data_ptr(), yr.data_ptr(), yi.data_ptr(),
        out.data_ptr(), B, ci, co, n,
        torch.cuda.current_stream(x.device).cuda_stream,
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
            # K3 on Q^H: (F, ci, co) views, so the output has ci channels
            dx = _launch(g, Qr.transpose(1, 2), -Qi.transpose(1, 2))
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
