"""Backbone feature extractors (counterpart of
``fiode_tpu/models/backbones.py``): the Cayley KWLarge flagship, the plain
4C3F / 6C2F CNNs whose Lipschitz constant the trainer tracks, and the small
MLP used by the tests.  All take NCHW images in [0, 1] and normalise inside
the model; ``make_backbone`` builds one by its config name."""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from .layers import (
    CayleyConv,
    CayleyLinear,
    GroupSort,
    LipsConv,
    LipsLinear,
    Normalize,
)

__all__ = ["KWLargeBackbone", "PlainCNNBackbone", "TinyMLPBackbone",
           "make_backbone"]

# (features, kernel, stride, padding) of each LipsConv, and the LipsLinear
# widths after the flatten (the last one is out_dim)
PLAIN_CNN = {
    "4C3F": ([(32, 3, 1, 1), (32, 4, 2, 1), (64, 3, 1, 1), (64, 4, 2, 1)],
             [512, 512]),
    "6C2F": ([(32, 3, 1, 1), (32, 3, 1, 1), (32, 4, 2, 1),
              (64, 3, 1, 1), (64, 3, 1, 1), (64, 4, 2, 1)], [512]),
}


def _act(name: str) -> nn.Module:
    if name == "GroupSort":
        return GroupSort()
    if name == "ReLU":
        return nn.ReLU()
    raise ValueError(f"unknown activation {name!r}")


class KWLargeBackbone(nn.Module):
    """Cayley orthogonal KWLarge: 4 convs + 3 linears.

    3x32x32 -> 32c3 -> 32c4/s2 -> 64c3 -> 64c4/s2 -> flatten -> 512 -> 512
    -> out_dim, with ``act`` after every layer but the last.  ``cached``
    builds the test / inference twin (``layers.cache_cayley_params`` fills
    it from a trained backbone); ``inter`` stops at the second 512-wide
    linear's activation and has no head.
    """

    def __init__(self, out_dim: int = 128, act: str = "GroupSort",
                 mu: Sequence[float] = (0.0,), std: Sequence[float] = (1.0,),
                 width: int = 1, in_channels: int = 3, img_size: int = 32,
                 generator: Optional[torch.Generator] = None,
                 cached: bool = False, inter: bool = False):
        super().__init__()
        w, g = width, generator
        self.inter = inter
        self.norm = Normalize(mu, std)
        self.act = _act(act)
        kw = dict(generator=g, cached=cached)
        self.convs = nn.ModuleList([
            CayleyConv(in_channels, 32 * w, 3, img_size=img_size, **kw),
            CayleyConv(32 * w, 32 * w, 4, stride=2, img_size=img_size, **kw),
            CayleyConv(32 * w, 64 * w, 3, img_size=img_size // 2, **kw),
            CayleyConv(64 * w, 64 * w, 4, stride=2, img_size=img_size // 2,
                       **kw),
        ])
        flat = 64 * w * (img_size // 4) ** 2
        self.linears = nn.ModuleList(
            [CayleyLinear(flat, 512 * w, **kw), CayleyLinear(512 * w, 512, **kw)]
            + ([] if inter else [CayleyLinear(512, out_dim, **kw)]))

    def forward(self, x):
        x = self.norm(x)
        for conv in self.convs:
            x = self.act(conv(x))
        x = x.reshape(x.shape[0], -1)
        x = self.act(self.linears[0](x))
        x = self.act(self.linears[1](x))
        return x if self.inter else self.linears[2](x)


class PlainCNNBackbone(nn.Module):
    """4C3F / 6C2F CNNs of LipsConv and LipsLinear layers (``PLAIN_CNN``),
    with ``act`` after every layer but the last."""

    def __init__(self, arch: str = "4C3F", out_dim: int = 10,
                 act: str = "ReLU", mu: Sequence[float] = (0.0,),
                 std: Sequence[float] = (1.0,), in_channels: int = 3,
                 img_size: int = 32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if arch not in PLAIN_CNN:
            raise ValueError(f"unknown arch {arch!r}")
        self.arch = arch
        convs, widths = PLAIN_CNN[arch]
        self.norm = Normalize(mu, std)
        self.act = _act(act)
        layers, c, hw = [], in_channels, img_size
        for co, k, s, p in convs:
            layers.append(LipsConv(c, co, k, s, p, generator=generator))
            c, hw = co, (hw + 2 * p - k) // s + 1
        self.convs = nn.ModuleList(layers)
        dims = [c * hw * hw] + widths + [out_dim]
        self.linears = nn.ModuleList([
            LipsLinear(a, b, generator=generator)
            for a, b in zip(dims[:-1], dims[1:])
        ])

    def forward(self, x):
        x = self.norm(x)
        for conv in self.convs:
            x = self.act(conv(x))
        x = x.reshape(x.shape[0], -1)
        for lin in self.linears[:-1]:
            x = self.act(lin(x))
        return self.linears[-1](x)


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


def make_backbone(name: str, *, out_dim: int, act: str, mu, std,
                  in_channels: int, img_size: int,
                  generator: Optional[torch.Generator] = None
                  ) -> Optional[nn.Module]:
    """The param_map registry of the JAX package's ``make_backbone``:
    ORTHO_KWLarge_Concat, ORTHO_KWLargeMNIST_Concat (KWLarge at the input's
    channels and size), their ``_test`` twins (cached Cayley transforms,
    to fill with ``layers.cache_cayley_params``), ORTHO_KWLarge_inter (the
    512-wide representation, no head), CIFAR_4C3F, CIFAR_4C3F_nolips,
    CIFAR_6C2F, TinyMLP, and Identity (no backbone: the dynamics see the
    flattened pixels)."""
    kw = dict(mu=mu, std=std, generator=generator)
    kwlarge = {"ORTHO_KWLarge_Concat": {}, "ORTHO_KWLargeMNIST_Concat": {},
               "ORTHO_KWLarge_Concat_test": {"cached": True},
               "ORTHO_KWLargeMNIST_Concat_test": {"cached": True},
               "ORTHO_KWLarge_inter": {"inter": True}}
    if name in kwlarge:
        return KWLargeBackbone(out_dim=out_dim, act=act,
                               in_channels=in_channels, img_size=img_size,
                               **kw, **kwlarge[name])
    if name in ("CIFAR_4C3F", "CIFAR_4C3F_nolips", "CIFAR_6C2F"):
        return PlainCNNBackbone("6C2F" if name == "CIFAR_6C2F" else "4C3F",
                                out_dim=out_dim, act=act,
                                in_channels=in_channels, img_size=img_size,
                                **kw)
    if name == "TinyMLP":
        return TinyMLPBackbone(in_channels * img_size * img_size,
                               out_dim=out_dim, **kw)
    if name == "Identity":
        return None
    raise ValueError(f"unknown backbone {name!r}")
