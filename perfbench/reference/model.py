"""Plain reference of the FI-ODE classifier: the KWLarge Cayley backbone and
the projected simplex dynamics, in plain float32 PyTorch from the raw
parameters (a dict keyed as the program's ``state_dict``).

Frozen copies, at commit 08631d7, of the plain versions in
``fiode_tpu_torch/ops/cayley.py`` (``cayley``, ``_fft_kernel``,
``cayley_conv_kernel``, the dense-DFT ``apply_freq_matrices``,
``groupsort2``), ``fiode_tpu_torch/models/layers.py`` (``Normalize``,
``space_to_depth``, the Cayley layers), ``fiode_tpu_torch/models/backbones.py``
(``KWLargeBackbone.forward``), ``fiode_tpu_torch/models/dynamics.py``
(``barrier_bounds``, ``SimplexDynamics.raw`` / ``eval_dot``) and
``fiode_tpu_torch/ops/simplex_qp.py`` (the bisection and the active-set VJP
of the cone projection).  No kernel, no cache, no batching: every
convolution is the dense rDFT as matrix products, every Cayley transform a
``torch.linalg.solve``.  Imports nothing of the program.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["cayley", "conv_freq_matrices", "freq_apply", "groupsort2",
           "space_to_depth", "backbone", "dense_dynamics", "rhs",
           "eval_dot_train", "cone_project", "injection"]

# KWLarge's four Cayley convs: a stride of 2 is a space_to_depth first
STRIDES = (1, 2, 1, 2)


def _herm(W):
    return W.transpose(-2, -1).conj()


def cayley(W: torch.Tensor) -> torch.Tensor:
    """Cayley transform of a (co, ci) or (batch, co, ci) matrix (square,
    tall or wide, real or complex)."""
    squeeze = W.ndim == 2
    if squeeze:
        W = W[None]
    _, co, ci = W.shape
    transposed = co < ci
    if transposed:
        W = _herm(W)
        co, ci = ci, co
    U, V = W[:, :ci, :], W[:, ci:, :]
    eye = torch.eye(ci, dtype=W.dtype, device=W.device)
    A = U - _herm(U) + _herm(V) @ V
    X = torch.linalg.solve(eye + A, eye.expand_as(A))
    Q = torch.cat([2.0 * X - eye, -2.0 * (V @ X)], dim=-2)
    if transposed:
        Q = _herm(Q)
    Q = Q.resolve_conj()
    return Q[0] if squeeze else Q


def linear_kernel(W, alpha):
    return cayley(alpha * W / torch.linalg.norm(W))


def conv_freq_matrices(weight, alpha, n: int) -> torch.Tensor:
    """(F, co, ci) complex: cayley(alpha rfft2(kernel) / ||.||_F) at size n."""
    co, ci, k, _ = weight.shape
    kernel = weight.new_zeros((co, ci, n, n))
    kernel[:, :, :k, :k] = weight
    kernel = torch.roll(kernel, (-(k // 2), -(k // 2)), dims=(-2, -1))
    wfft = torch.fft.rfft2(kernel).permute(2, 3, 0, 1).reshape(-1, co, ci)
    wfft = torch.conj_physical(wfft)
    return cayley((alpha / torch.linalg.norm(wfft)) * wfft)


def _dft_mats(n: int, device):
    """Dense rDFT matrices as float32 (D2r, D2i, M2r, M2i): D2 (F, n n)
    maps pixels to the retained frequencies, y = Re(M2 Y) inverts."""
    k = np.arange(n)
    D = np.exp(-2j * np.pi * np.outer(k, k) / n)
    nf = n // 2 + 1
    w = np.ones(nf)
    w[1:(n + 1) // 2] = 2.0
    Dinv = np.conj(D) / n
    Einv = (np.conj(D[:nf]).T * w[None, :]) / n
    D2 = np.einsum("fi,gj->fgij", D, D[:nf]).reshape(n * nf, n * n)
    M2 = np.einsum("af,bg->abfg", Dinv, Einv).reshape(n * n, n * nf)
    D2, M2 = D2.astype(np.complex64), M2.astype(np.complex64)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (D2.real, D2.imag, M2.real, M2.imag))


def freq_apply(x, Q):
    """Per-frequency (F, co, ci) complex matrices applied to NCHW x through
    the dense rDFT: (B, co, n, n)."""
    B, ci, n, _ = x.shape
    co, F = Q.shape[-2], Q.shape[0]
    D2r, D2i, M2r, M2i = _dft_mats(n, x.device)
    xp = x.reshape(B, ci, n * n)
    Xr = (xp @ D2r.T).permute(2, 1, 0)
    Xi = (xp @ D2i.T).permute(2, 1, 0)
    Qr, Qi = Q.real, Q.imag
    Yr = (Qr @ Xr - Qi @ Xi).reshape(F, co * B)
    Yi = (Qr @ Xi + Qi @ Xr).reshape(F, co * B)
    y = M2r @ Yr - M2i @ Yi
    return y.reshape(n, n, co, B).permute(3, 2, 0, 1).contiguous()


def groupsort2(x, dim: int = -1):
    """[min, max] of each pair along ``dim``."""
    dim = dim % x.ndim
    n = x.shape[dim]
    a, b = x.unflatten(dim, (n // 2, 2)).unbind(dim + 1)
    return torch.stack([torch.minimum(a, b), torch.maximum(a, b)],
                       dim + 1).flatten(dim, dim + 1)


def space_to_depth(x, block: int = 2):
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // block, block, w // block, block)
    return x.permute(0, 1, 3, 5, 2, 4).reshape(b, c * block * block,
                                               h // block, w // block)


def backbone(P: dict, x, cfg: dict, prefix: str = "backbone."):
    """KWLarge features of NCHW images x in [0, 1]: Normalize, four Cayley
    convs (two after a space_to_depth) and two Cayley linears, each with
    GroupSort, then the Cayley head."""
    mu = torch.tensor(cfg["mu"], device=x.device).reshape(-1, 1, 1)
    std = torch.tensor(cfg["std"], device=x.device).reshape(-1, 1, 1)
    x = (x - mu) / std
    for i, stride in enumerate(STRIDES):
        p = f"{prefix}convs.{i}."
        if stride == 2:
            x = space_to_depth(x, 2)
        Q = conv_freq_matrices(P[p + "weight"], P[p + "alpha"], x.shape[-1])
        x = freq_apply(x, Q) + P[p + "bias"][None, :, None, None]
        x = groupsort2(x, 1)
    x = x.reshape(x.shape[0], -1)
    for i in range(3):
        p = f"{prefix}linears.{i}."
        x = x @ linear_kernel(P[p + "weight"], P[p + "alpha"]).T + P[p + "bias"]
        if i < 2:
            x = groupsort2(x, -1)
    return x


def dense_dynamics(P: dict, prefix: str = "dynamics.") -> dict:
    """Each dynamics layer as (Q (out, in), bias)."""
    return {name: (linear_kernel(P[f"{prefix}{name}.weight"],
                                 P[f"{prefix}{name}.alpha"]),
                   P[f"{prefix}{name}.bias"])
            for name in ("hidden_to_mlp", "U_x", "mlp_to_mlp", "mlp_to_hidden")}


def _bisect_mu(lower, nominal, n_iter):
    lo = nominal.amin(-1, keepdim=True)
    hi = (nominal - lower).amax(-1, keepdim=True)
    for _ in range(n_iter):
        mid = 0.5 * (lo + hi)
        s = torch.maximum(nominal - mid, lower).sum(-1, keepdim=True)
        lo = torch.where(s > 0, mid, lo)
        hi = torch.where(s < 0, mid, hi)
    return 0.5 * (lo + hi)


class _Cone(torch.autograd.Function):
    """Projection onto {v : sum v = 0, v >= lower} by bisection on the dual;
    backward: the active-set Jacobian (the branch the clamp took)."""

    @staticmethod
    def forward(ctx, lower, nominal, n_iter):
        mu = _bisect_mu(lower, nominal, n_iter)
        ctx.save_for_backward(mu, lower, nominal)
        return torch.maximum(nominal - mu, lower)

    @staticmethod
    def backward(ctx, g):
        mu, lower, nominal = ctx.saved_tensors
        active = (nominal - mu) < lower
        free = ~active
        n_free = free.sum(-1, keepdim=True).to(g.dtype).clamp_min(1.0)
        corr = torch.where(free, g, 0.0).sum(-1, keepdim=True) / n_free
        return (torch.where(active, g - corr, 0.0),
                torch.where(free, g - corr, 0.0), None)


def cone_project(lower, nominal, n_iter: int = 30):
    return _Cone.apply(lower, nominal, n_iter)


def rhs(h, xc, dense: dict, cfg: dict, scale_nominal: bool):
    """The projected ReLU dynamics f(h) on the injection xc = x U^T + bU + b1."""
    W1, _ = dense["hidden_to_mlp"]
    W2, b2 = dense["mlp_to_mlp"]
    W3, b3 = dense["mlp_to_hidden"]
    z = torch.relu(torch.relu(h @ W1.T + xc) @ W2.T + b2)
    f = z @ W3.T + b3
    return _project(h, f, cfg, scale_nominal)


def _project(h, f, cfg, scale_nominal):
    a1, s1, a2 = cfg["alpha_1"], cfg["sigma_1"], cfg["alpha_2"]
    lower = -a1 * (torch.exp(s1 * h) - 1.0)
    if scale_nominal:
        f = (a2 * (1.0 - h) - lower) * torch.sigmoid(f) + lower
    return cone_project(lower, f, cfg["qp_iters"])


def injection(feats, dense: dict):
    """xc = feats U^T + bU + b1, the MLP's first pre-activation's constant."""
    U, bU = dense["U_x"]
    return feats @ U.T + bU + dense["hidden_to_mlp"][1]


def eval_dot_train(h, x, dense: dict, cfg: dict, masks, scale_nominal: bool):
    """The dynamics with dropout (the training path): ``masks`` are the two
    uniform draws (rows, mlp) deciding which activations are kept."""
    keep = 1.0 - cfg["dropout"]
    W1, b1 = dense["hidden_to_mlp"]
    U, bU = dense["U_x"]
    W2, b2 = dense["mlp_to_mlp"]
    W3, b3 = dense["mlp_to_hidden"]
    zero = torch.zeros((), device=h.device)
    z = h @ W1.T + b1 + x @ U.T + bU
    z = torch.relu(torch.where(masks[0] < keep, z / keep, zero))
    z = z @ W2.T + b2
    z = torch.relu(torch.where(masks[1] < keep, z / keep, zero))
    return _project(h, z @ W3.T + b3, cfg, scale_nominal)
