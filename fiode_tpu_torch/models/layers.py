"""Layers (counterpart of ``fiode_tpu/models/layers.py``): Normalize,
GroupSort, space_to_depth, CayleyLinear, CayleyConv (each also as the
``cached=True`` twin that ``cache_cayley_params`` fills), LipsLinear and
LipsConv; the Cayley layers with or without a bias (``use_bias``).

Weights keep the JAX layouts: (out, in) for linears, (co, ci, k, k) for
convs, NCHW activations.  Initialisers follow flax's variance scaling
(scale 2, fan_out as flax counts it) and draw from an explicit
``torch.Generator``.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from ..ops.cayley import cayley_conv_kernel, cayley_linear_kernel, groupsort2
from ..ops.fused_cayley_conv import fused_freq_apply

__all__ = [
    "Normalize",
    "GroupSort",
    "space_to_depth",
    "CayleyLinear",
    "CayleyConv",
    "LipsLinear",
    "LipsConv",
    "cache_cayley_params",
]

# flax's truncated-normal variance scaling divides the std by the std of a
# unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def _flax_fan_out(shape) -> int:
    """flax ``_compute_fans`` fan_out: the last axis times the receptive
    field (every axis but the last two)."""
    receptive = math.prod(shape[:-2])
    return shape[-1] * receptive


def _variance_scaling(shape, generator, truncated: bool) -> torch.Tensor:
    std = math.sqrt(2.0 / _flax_fan_out(shape))
    w = torch.empty(shape)
    if truncated:
        std /= _TRUNC_STD
        nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)
    else:
        nn.init.normal_(w, 0.0, std, generator=generator)
    return w


class Normalize(nn.Module):
    """(x - mu) / std per channel of an NCHW input."""

    def __init__(self, mu: Sequence[float], std: Sequence[float]):
        super().__init__()
        # the values as given (double precision): a certifier's Lipschitz
        # constant 1 / min(std) is taken from these, not from the buffer
        self.std_values = tuple(float(v) for v in std)
        self.register_buffer("mu", torch.tensor(mu).reshape(-1, 1, 1),
                             persistent=False)
        self.register_buffer("std", torch.tensor(std).reshape(-1, 1, 1),
                             persistent=False)

    def forward(self, x):
        return (x - self.mu) / self.std


class GroupSort(nn.Module):
    """MaxMin over pairs of channels: axis 1 for NCHW, the last otherwise."""

    def forward(self, x):
        return groupsort2(x, 1 if x.ndim == 4 else -1)


def space_to_depth(x: torch.Tensor, block: int = 2) -> torch.Tensor:
    """Invertible downsampling (B, C, H, W) -> (B, C*block^2, H/b, W/b);
    output channel c * block^2 + bi * block + bj."""
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // block, block, w // block, block)
    x = x.permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, c * block * block, h // block, w // block)


class CayleyLinear(nn.Module):
    """Orthogonal linear layer y = x Q^T + b, Q = cayley(alpha W / ||W||).

    ``cached=True`` is the test / inference twin: Q itself is the parameter,
    filled once from trained weights by ``cache_cayley_params``, so no
    Cayley transform runs in the forward.  It starts as NaN, so that a twin
    used unfilled gives NaN features instead of plausible ones.
    """

    def __init__(self, in_features: int, out_features: int,
                 generator: Optional[torch.Generator] = None,
                 use_bias: bool = True, cached: bool = False):
        super().__init__()
        self.cached = cached
        if cached:
            # laid out as cayley() lays out Q (transposed storage when wide),
            # so that x @ Q^T runs the same product as the uncached layer
            Q = torch.full((in_features, out_features), float("nan")).T
            if out_features >= in_features:
                Q = Q.contiguous()
            self.Q = nn.Parameter(Q)
        else:
            w = _variance_scaling((out_features, in_features), generator, True)
            self.weight = nn.Parameter(w)
            self.alpha = nn.Parameter(torch.linalg.norm(w))
        self.bias = nn.Parameter(torch.zeros(out_features)) if use_bias else None

    def kernel(self) -> torch.Tensor:
        """The orthogonal (out, in) matrix Q."""
        if self.cached:
            return self.Q
        return cayley_linear_kernel(self.weight, self.alpha)

    def forward(self, x):
        y = x @ self.kernel().T
        return y if self.bias is None else y + self.bias


class CayleyConv(nn.Module):
    """Orthogonal circular convolution (Fourier-domain Cayley), NCHW.

    stride=2 is space_to_depth(2) followed by a stride-1 orthogonal conv
    with kernel ceil(k/2); ``in_channels`` counts the channels before it.
    The frequency apply is ``fused_freq_apply`` (kernel K3 on CUDA).

    ``cached=True`` is the test / inference twin for inputs of spatial size
    ``img_size`` (before the space_to_depth): its parameters are the
    per-frequency matrices Q (F, co, ci), F = n (n // 2 + 1) at the conv's
    own size n, as real and imaginary parts ``Qr`` and ``Qi``, filled once
    by ``cache_cayley_params`` (NaN until then); the forward is K3 with
    them, and no Cayley transform runs.
    """

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 stride: int = 1,
                 generator: Optional[torch.Generator] = None,
                 use_bias: bool = True, cached: bool = False,
                 img_size: Optional[int] = None):
        super().__init__()
        if stride == 2:
            in_channels *= 4
            kernel_size = max(1, (kernel_size + 1) // 2)
        elif stride != 1:
            raise ValueError("CayleyConv supports stride 1 or 2")
        self.stride = stride
        self.cached = cached
        if cached:
            if img_size is None:
                raise ValueError("a cached CayleyConv needs img_size")
            n = img_size // stride
            shape = (n * (n // 2 + 1), features, in_channels)
            self.n = n
            self.Qr = nn.Parameter(torch.full(shape, float("nan")))
            self.Qi = nn.Parameter(torch.full(shape, float("nan")))
        else:
            w = _variance_scaling(
                (features, in_channels, kernel_size, kernel_size), generator,
                True)
            self.weight = nn.Parameter(w)
            self.alpha = nn.Parameter(torch.linalg.norm(w))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def freq_matrices(self, n: int):
        """(Qr, Qi), the real and imaginary parts of Q (F, co, ci) at
        spatial size n."""
        if self.cached:
            if n != self.n:
                raise ValueError(f"this cached CayleyConv holds Q for n = "
                                 f"{self.n}, not {n}")
            return self.Qr, self.Qi
        Q = cayley_conv_kernel(self.weight, self.alpha, n)
        return Q.real.contiguous(), Q.imag.contiguous()

    def forward(self, x):
        if self.stride == 2:
            x = space_to_depth(x, 2)
        y = fused_freq_apply(x, *self.freq_matrices(x.shape[-1]))
        return y if self.bias is None else y + self.bias[None, :, None, None]


@torch.no_grad()
def cache_cayley_params(cached: nn.Module, trained: nn.Module) -> nn.Module:
    """Fill the ``cached=True`` twin ``cached`` from ``trained`` in place:
    every cached CayleyLinear gets Q = cayley_linear_kernel of the trained
    weights, every cached CayleyConv its per-frequency Q at its size, and
    every other parameter and buffer (biases, plain layers, the dynamics) is
    copied.  The two modules must have the same structure.  Returns
    ``cached``."""
    src = dict(trained.named_modules())
    for name, mod in cached.named_modules():
        if isinstance(mod, CayleyLinear) and mod.cached:
            t = src[name]
            mod.Q.copy_(cayley_linear_kernel(t.weight, t.alpha))
        elif isinstance(mod, CayleyConv) and mod.cached:
            t = src[name]
            Q = cayley_conv_kernel(t.weight, t.alpha, mod.n)
            mod.Qr.copy_(Q.real)
            mod.Qi.copy_(Q.imag)
    theirs = trained.state_dict()
    for k, v in cached.state_dict().items():
        if k in theirs:
            v.copy_(theirs[k])
    return cached


class LipsLinear(nn.Module):
    """Plain linear layer y = x W^T + b (spectral norm tracked elsewhere)."""

    def __init__(self, in_features: int, out_features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = nn.Parameter(
            _variance_scaling((out_features, in_features), generator, False)
        )
        self.bias = nn.Parameter(torch.zeros(out_features))

    def kernel(self) -> torch.Tensor:
        """The (out, in) matrix, the weight itself."""
        return self.weight

    def forward(self, x):
        return x @ self.weight.T + self.bias


class LipsConv(nn.Module):
    """Plain NCHW cross-correlation with zero padding (spectral norm tracked
    elsewhere); He-normal weights, std sqrt(2 / (k * k * features))."""

    def __init__(self, in_channels: int, features: int, kernel_size: int,
                 stride: int = 1, padding: int = 0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.stride = stride
        self.padding = padding
        k = kernel_size
        w = torch.empty((features, in_channels, k, k))
        nn.init.normal_(w, 0.0, math.sqrt(2.0 / (k * k * features)),
                        generator=generator)
        self.weight = nn.Parameter(w)
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self.stride, self.padding)
