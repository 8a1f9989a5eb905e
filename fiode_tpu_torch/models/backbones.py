"""Backbone feature extractors (counterpart of
``fiode_tpu/models/backbones.py``): the Cayley KWLarge flagship and the
small MLP used by the tests.  Both take NCHW images in [0, 1] and normalise
inside the model."""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from .layers import CayleyConv, CayleyLinear, GroupSort, LipsLinear, Normalize

__all__ = ["KWLargeBackbone", "TinyMLPBackbone"]


def _act(name: str) -> nn.Module:
    if name == "GroupSort":
        return GroupSort()
    if name == "ReLU":
        return nn.ReLU()
    raise ValueError(f"unknown activation {name!r}")


class KWLargeBackbone(nn.Module):
    """Cayley orthogonal KWLarge: 4 convs + 3 linears.

    3x32x32 -> 32c3 -> 32c4/s2 -> 64c3 -> 64c4/s2 -> flatten -> 512 -> 512
    -> out_dim, with ``act`` after every layer but the last.
    """

    def __init__(self, out_dim: int = 128, act: str = "GroupSort",
                 mu: Sequence[float] = (0.0,), std: Sequence[float] = (1.0,),
                 width: int = 1, in_channels: int = 3, img_size: int = 32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        w, g = width, generator
        self.norm = Normalize(mu, std)
        self.act = _act(act)
        self.convs = nn.ModuleList([
            CayleyConv(in_channels, 32 * w, 3, generator=g),
            CayleyConv(32 * w, 32 * w, 4, stride=2, generator=g),
            CayleyConv(32 * w, 64 * w, 3, generator=g),
            CayleyConv(64 * w, 64 * w, 4, stride=2, generator=g),
        ])
        flat = 64 * w * (img_size // 4) ** 2
        self.linears = nn.ModuleList([
            CayleyLinear(flat, 512 * w, generator=g),
            CayleyLinear(512 * w, 512, generator=g),
            CayleyLinear(512, out_dim, generator=g),
        ])

    def forward(self, x):
        x = self.norm(x)
        for conv in self.convs:
            x = self.act(conv(x))
        x = x.reshape(x.shape[0], -1)
        x = self.act(self.linears[0](x))
        x = self.act(self.linears[1](x))
        return self.linears[2](x)


class TinyMLPBackbone(nn.Module):
    """Small flatten -> MLP feature map (tests and fast CPU experiments)."""

    def __init__(self, in_features: int, out_dim: int = 10, hidden: int = 64,
                 mu: Sequence[float] = (0.0,), std: Sequence[float] = (1.0,),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.norm = Normalize(mu, std)
        self.linears = nn.ModuleList([
            LipsLinear(in_features, hidden, generator=generator),
            LipsLinear(hidden, out_dim, generator=generator),
        ])

    def forward(self, x):
        x = self.norm(x).reshape(x.shape[0], -1)
        return self.linears[1](torch.relu(self.linears[0](x)))
