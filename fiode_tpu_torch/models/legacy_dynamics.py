"""Legacy conv-feature dynamics (counterpart of
``fiode_tpu/models/legacy_dynamics.py``), NCHW throughout.

  * ``ConvBlockDynamics``: an ODE over an image-shaped state h (B, C, H, W)
    with the input image injected through a stem, f(h, x) = block(h) +
    relu(stem(x)); ``state_init(x) = relu(stem(x))`` gives h(0);
  * ``DynBasicBlock`` (conv-norm-relu-conv-norm) and ``DynBottleneck``
    (1x1 squeeze to C / expansion, 3x3, 1x1 back to C, a norm after each,
    relu after the first two): ResNet block shapes with no residual add;
  * ``ResNetOutput``: global average pool and a linear readout to logits.

The convolutions are ``F.conv2d`` without bias, padded as flax's "SAME"
(1 for k = 3, 0 for k = 1).  GroupNorm uses flax's epsilon, 1e-6 (torch's
default is 1e-5), with 8 groups, or for the bottleneck the largest of 8,
4, 2, 1 that divides the channels.  The submodules keep the flax names
(``Conv_0``, ``GroupNorm_0``, ``Dense_0``) so that ``bridge`` carries the
JAX package's parameters over; the weights are initialised as flax does
(lecun-normal convs and readout, unit norms), from ``generator``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

__all__ = ["ConvBlockDynamics", "DynBasicBlock", "DynBottleneck",
           "ResNetOutput"]

GN_EPS = 1e-6  # flax nn.GroupNorm's epsilon
_TRUNC_STD = 0.87962566103423978  # std of a unit normal truncated to [-2, 2]


def _lecun(shape, fan_in, generator):
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    w = torch.empty(shape)
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)
    return w


class _Conv(nn.Module):
    """Bias-free NCHW conv, "SAME" padding at stride 1."""

    def __init__(self, in_channels: int, features: int, k: int,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.weight = nn.Parameter(_lecun((features, in_channels, k, k),
                                          k * k * in_channels, generator))

    def forward(self, x):
        return F.conv2d(x, self.weight, padding=self.weight.shape[-1] // 2)


def _groups(ch: int) -> int:
    return next(g for g in (8, 4, 2, 1) if ch % g == 0)


class DynBasicBlock(nn.Module):
    """conv3-norm-relu-conv3-norm over ``features`` channels (no residual)."""

    def __init__(self, features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.Conv_0 = _Conv(features, features, 3, generator)
        self.GroupNorm_0 = nn.GroupNorm(8, features, eps=GN_EPS)
        self.Conv_1 = _Conv(features, features, 3, generator)
        self.GroupNorm_1 = nn.GroupNorm(8, features, eps=GN_EPS)

    def forward(self, h):
        x = torch.relu(self.GroupNorm_0(self.Conv_0(h)))
        return self.GroupNorm_1(self.Conv_1(x))


class DynBottleneck(nn.Module):
    """1x1 squeeze to max(features // expansion, 1), 3x3, 1x1 back to
    ``features``, a norm after each and relu after the first two (no
    residual): as an ODE's RHS it keeps h's channels."""

    def __init__(self, features: int, expansion: int = 4,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        w = max(features // expansion, 1)
        g = generator
        self.Conv_0 = _Conv(features, w, 1, g)
        self.Conv_1 = _Conv(w, w, 3, g)
        self.Conv_2 = _Conv(w, features, 1, g)
        self.GroupNorm_0 = nn.GroupNorm(_groups(w), w, eps=GN_EPS)
        self.GroupNorm_1 = nn.GroupNorm(_groups(w), w, eps=GN_EPS)
        self.GroupNorm_2 = nn.GroupNorm(_groups(features), features,
                                        eps=GN_EPS)

    def forward(self, h):
        x = torch.relu(self.GroupNorm_0(self.Conv_0(h)))
        x = torch.relu(self.GroupNorm_1(self.Conv_1(x)))
        return self.GroupNorm_2(self.Conv_2(x))


class ConvBlockDynamics(nn.Module):
    """f(h, x) = block(h) + relu(stem(x)) over an image-shaped state of
    ``features`` channels; ``block`` is "basic" or "bottleneck", ``stem`` a
    3x3 conv from the image's ``in_channels``."""

    def __init__(self, features: int = 32, block: str = "basic",
                 in_channels: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if block not in ("basic", "bottleneck"):
            raise ValueError(f"block must be 'basic' or 'bottleneck', got {block!r}")
        self.stem = _Conv(in_channels, features, 3, generator)
        self.body = (DynBasicBlock(features, generator=generator)
                     if block == "basic"
                     else DynBottleneck(features, generator=generator))

    def state_init(self, x):
        """h(0) = relu(stem(x))."""
        return torch.relu(self.stem(x))

    def eval_dot(self, h, x, *, train: bool = False, scale_nominal=None):
        return self.body(h) + torch.relu(self.stem(x))

    def forward(self, h, x, **kw):
        return self.eval_dot(h, x, **kw)


class ResNetOutput(nn.Module):
    """Global average pool over (H, W), then a linear map to logits."""

    def __init__(self, in_channels: int, n_classes: int = 10,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.Dense_0 = nn.Linear(in_channels, n_classes)
        with torch.no_grad():
            self.Dense_0.weight.copy_(_lecun((n_classes, in_channels),
                                             in_channels, generator))
            self.Dense_0.bias.zero_()

    def forward(self, h):
        return self.Dense_0(h.mean(dim=(2, 3)))
