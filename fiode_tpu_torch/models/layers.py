"""Layers (counterpart of ``fiode_tpu/models/layers.py``): Normalize,
GroupSort, space_to_depth, CayleyLinear, CayleyConv and LipsLinear.

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

from ..ops.cayley import cayley_conv_kernel, cayley_linear_kernel, groupsort2
from ..ops.fused_cayley_conv import fused_freq_apply

__all__ = [
    "Normalize",
    "GroupSort",
    "space_to_depth",
    "CayleyLinear",
    "CayleyConv",
    "LipsLinear",
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
    """Orthogonal linear layer y = x Q^T + b, Q = cayley(alpha W / ||W||)."""

    def __init__(self, in_features: int, out_features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        w = _variance_scaling((out_features, in_features), generator, True)
        self.weight = nn.Parameter(w)
        self.alpha = nn.Parameter(torch.linalg.norm(w))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def kernel(self) -> torch.Tensor:
        """The orthogonal (out, in) matrix Q."""
        return cayley_linear_kernel(self.weight, self.alpha)

    def forward(self, x):
        return x @ self.kernel().T + self.bias


class CayleyConv(nn.Module):
    """Orthogonal circular convolution (Fourier-domain Cayley), NCHW.

    stride=2 is space_to_depth(2) followed by a stride-1 orthogonal conv
    with kernel ceil(k/2); ``in_channels`` counts the channels before it.
    The frequency apply is ``fused_freq_apply`` (kernel K3 on CUDA).
    """

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 stride: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if stride == 2:
            in_channels *= 4
            kernel_size = max(1, (kernel_size + 1) // 2)
        elif stride != 1:
            raise ValueError("CayleyConv supports stride 1 or 2")
        self.stride = stride
        w = _variance_scaling(
            (features, in_channels, kernel_size, kernel_size), generator, True
        )
        self.weight = nn.Parameter(w)
        self.alpha = nn.Parameter(torch.linalg.norm(w))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        if self.stride == 2:
            x = space_to_depth(x, 2)
        Q = cayley_conv_kernel(self.weight, self.alpha, x.shape[-1])
        y = fused_freq_apply(x, Q.real.contiguous(), Q.imag.contiguous())
        return y + self.bias[None, :, None, None]


class LipsLinear(nn.Module):
    """Plain linear layer y = x W^T + b (spectral norm tracked elsewhere)."""

    def __init__(self, in_features: int, out_features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = nn.Parameter(
            _variance_scaling((out_features, in_features), generator, False)
        )
        self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x):
        return x @ self.weight.T + self.bias
