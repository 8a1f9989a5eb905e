"""Cayley-transform orthogonal parameterisations (counterpart of
``fiode_tpu/ops/cayley.py``).

  * ``cayley(W)``            dense Cayley transform, square / tall / wide,
                             real or complex, batched over a leading axis.
  * ``cayley_linear_kernel`` W -> cayley(alpha W / ||W||_F).
  * ``cayley_conv_kernel``   per-frequency semi-orthogonal matrices (F, co, ci)
                             of a circular conv at spatial size n,
                             F = n * (n // 2 + 1), ordered f * nf + g.
  * ``apply_freq_matrices``  apply them to an NCHW input: ``impl="dft"``
                             (dense rDFT matrices, the plain version of the
                             fused kernel K3), ``impl="dft1"`` (the same
                             transform as 1-D DFTs, rows then columns) or
                             ``impl="fft"`` (torch.fft).  These are plain
                             versions: on CUDA the layers apply Q with K3
                             whatever ``impl`` is.
  * ``groupsort2``           MaxMin activation over channel pairs.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = [
    "cayley",
    "cayley_linear_kernel",
    "cayley_conv_kernel",
    "apply_freq_matrices",
    "groupsort2",
]


def _herm(W: torch.Tensor) -> torch.Tensor:
    """Conjugate transpose of the last two axes (plain transpose if real)."""
    return W.transpose(-2, -1).conj()


def cayley(W: torch.Tensor) -> torch.Tensor:
    """Cayley transform of a (co, ci) or (batch, co, ci) matrix.

    Square W: (I - A)(I + A)^{-1} with A = W - W^H.  Tall W (co > ci):
    split into U (ci x ci) and V, A = U - U^H + V^H V, and stack
    [(I + A)^{-1}(I - A); -2 V (I + A)^{-1}] (orthonormal columns).  Wide W
    (co < ci) uses the conjugate-transposed construction.
    """
    squeeze = W.ndim == 2
    if squeeze:
        W = W[None]
    _, co, ci = W.shape
    transposed = co < ci
    if transposed:
        W = _herm(W)
        co, ci = ci, co
    U = W[:, :ci, :]
    V = W[:, ci:, :]
    eye = torch.eye(ci, dtype=W.dtype, device=W.device)
    A = U - _herm(U) + _herm(V) @ V
    # one factorisation serves both blocks: (I+A)^{-1}(I-A) = 2(I+A)^{-1} - I
    X = torch.linalg.solve(eye + A, eye.expand_as(A))
    Q = torch.cat([2.0 * X - eye, -2.0 * (V @ X)], dim=-2)
    if transposed:
        Q = _herm(Q)
    Q = Q.resolve_conj()
    return Q[0] if squeeze else Q


def cayley_linear_kernel(W: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """The CayleyLinear weight map cayley(alpha * W / ||W||_F)."""
    return cayley(alpha * W / torch.linalg.norm(W))


def _fft_kernel(weight: torch.Tensor, n: int) -> torch.Tensor:
    """rfft2 of a (co, ci, k, k) kernel zero-padded to (n, n) and rolled so
    the centre tap sits at 0; returns (n * (n//2+1), co, ci) complex,
    conjugated."""
    co, ci, k, _ = weight.shape
    kernel = weight.new_zeros((co, ci, n, n))
    kernel[:, :, :k, :k] = weight
    shift = -(k // 2)
    kernel = torch.roll(kernel, (shift, shift), dims=(-2, -1))
    wfft = torch.fft.rfft2(kernel)  # (co, ci, n, n//2+1)
    wfft = wfft.permute(2, 3, 0, 1).reshape(-1, co, ci)
    return torch.conj_physical(wfft)


def cayley_conv_kernel(weight: torch.Tensor, alpha: torch.Tensor,
                       n: int) -> torch.Tensor:
    """Per-frequency semi-orthogonal matrices (F, co, ci) of a CayleyConv at
    spatial size n: cayley(alpha * rfft2(kernel) / ||.||_F)."""
    wfft = _fft_kernel(weight, n)
    return cayley((alpha / torch.linalg.norm(wfft)) * wfft)


@functools.lru_cache(maxsize=16)
def _dft1_mats(n: int):
    """1-D DFT factors (complex128 numpy), as in the JAX package:
    ``D`` (n, n) full DFT, ``Dh`` (nf, n) rfft rows, ``Dinv`` (n, n) inverse,
    ``Einv`` (n, nf) inverse along the rfft axis with the Hermitian doubling
    weights folded in (so only the real part is needed)."""
    k = np.arange(n)
    D = np.exp(-2j * np.pi * np.outer(k, k) / n)
    nf = n // 2 + 1
    Dh = D[:nf]
    w = np.ones(nf)
    w[1:(n + 1) // 2] = 2.0
    Dinv = np.conj(D) / n
    Einv = (np.conj(Dh).T * w[None, :]) / n
    return D, Dh, Dinv, Einv


@functools.lru_cache(maxsize=16)
def _dft2_mats(n: int):
    """Dense 2-D rDFT matrices (complex64 numpy): ``D2`` (F, n*n) maps pixels
    to the F retained frequencies, ``M2`` (n*n, F) maps back so that
    ``y = Re(M2 @ Y)`` equals irfft2."""
    nf = n // 2 + 1
    D, Dh, Dinv, Einv = _dft1_mats(n)
    D2 = np.einsum("fi,gj->fgij", D, Dh).reshape(n * nf, n * n)
    M2 = np.einsum("af,bg->abfg", Dinv, Einv).reshape(n * n, n * nf)
    return D2.astype(np.complex64), M2.astype(np.complex64)


@functools.lru_cache(maxsize=32)
def _dft1_tensors(n: int, device: torch.device):
    """(D, Dh, Dinv, Einv) as complex64 tensors on ``device``."""
    return tuple(torch.from_numpy(a.astype(np.complex64)).to(device)
                 for a in _dft1_mats(n))


@functools.lru_cache(maxsize=32)
def _dft2_tensors(n: int, device: torch.device):
    """(D2.real, D2.imag, M2.real, M2.imag) as float32 tensors on ``device``."""
    D2, M2 = _dft2_mats(n)
    return tuple(
        torch.from_numpy(np.ascontiguousarray(a)).to(device)
        for a in (D2.real, D2.imag, M2.real, M2.imag)
    )


def apply_freq_matrices(x: torch.Tensor, Q: torch.Tensor, *,
                        impl: str = "dft") -> torch.Tensor:
    """Apply per-frequency (F, co, ci) complex matrices to NCHW ``x``
    (circular convolution in the Fourier domain); returns (B, co, n, n)."""
    B, ci, n, _ = x.shape
    co = Q.shape[-2]
    nf = n // 2 + 1
    F = n * nf
    if impl == "dft":
        D2r, D2i, M2r, M2i = _dft2_tensors(n, x.device)
        xp = x.reshape(B, ci, n * n)
        # (B, ci, p) . (F, p) -> (F, ci, B): frequency as the batch axis
        Xr = (xp @ D2r.T).permute(2, 1, 0)
        Xi = (xp @ D2i.T).permute(2, 1, 0)
        Qr, Qi = Q.real, Q.imag
        Yr = (Qr @ Xr - Qi @ Xi).reshape(F, co * B)
        Yi = (Qr @ Xi + Qi @ Xr).reshape(F, co * B)
        y = M2r @ Yr - M2i @ Yi  # (p, co * B)
        return y.reshape(n, n, co, B).permute(3, 2, 0, 1).contiguous()
    if impl == "dft1":
        # rows then columns: the rfft along the last axis, the full DFT along
        # the other, the mix, and the two inverses (Hermitian weights folded
        # into Einv, so the real part is the result)
        D, Dh, Dinv, Einv = _dft1_tensors(n, x.device)
        xf = D @ (x.to(torch.complex64) @ Dh.T)  # (B, ci, n, nf)
        xf = xf.permute(2, 3, 1, 0).reshape(F, ci, B)
        yf = (Q @ xf).reshape(n, nf, co, B).permute(3, 2, 0, 1)
        return (Dinv @ (yf @ Einv.T)).real.contiguous()
    if impl == "fft":
        xf = torch.fft.rfft2(x)  # (B, ci, n, nf)
        xf = xf.permute(2, 3, 1, 0).reshape(F, ci, B)
        yf = (Q @ xf).reshape(n, nf, co, B).permute(3, 2, 0, 1)
        return torch.fft.irfft2(yf, s=(n, n))
    raise ValueError(f"impl must be 'dft', 'dft1' or 'fft', got {impl!r}")


def groupsort2(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """GroupSort with group size 2: [min, max] of each pair along ``dim``."""
    dim = dim % x.ndim
    n = x.shape[dim]
    if n % 2:
        raise ValueError(f"groupsort2 needs an even dimension, got {n}")
    # elementwise min/max of the two halves of each pair, in place along
    # dim: no transposed copies of the (large) activation
    a, b = x.unflatten(dim, (n // 2, 2)).unbind(dim + 1)
    out = torch.stack([torch.minimum(a, b), torch.maximum(a, b)], dim + 1)
    return out.flatten(dim, dim + 1)
