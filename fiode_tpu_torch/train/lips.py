"""Backbone Lipschitz tracking for the Lipschitz-aware kappa (counterpart
of ``fiode_tpu/train/lips.py``).

``compute_lfx`` multiplies power-iteration sigma_max estimates through a
plain backbone's LipsConv and LipsLinear layers, warm-starting each layer's
singular vector from the state ``lfx_init`` made (a dict keyed by the flax
layer names, ``LipsConv_0`` ...).  A Cayley backbone is orthogonal with
GroupSort activations and isometric downsampling: its constant is 1 and it
has no state.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..models.backbones import PlainCNNBackbone, TinyMLPBackbone
from ..ops.power_iteration import power_iteration_conv, power_iteration_dense

__all__ = ["lfx_spec", "lfx_init", "compute_lfx"]


def lfx_spec(backbone, input_shape) -> Optional[list]:
    """(name, layer, stride, padding, input shape) per tracked layer, or
    None when the backbone's constant is 1 by construction."""
    if not isinstance(backbone, (PlainCNNBackbone, TinyMLPBackbone)):
        return None
    spec = []
    c, h, w = input_shape
    for i, conv in enumerate(getattr(backbone, "convs", [])):
        k = conv.weight.shape[-1]
        s, p = conv.stride, conv.padding
        spec.append((f"LipsConv_{i}", conv, s, p, (c, h, w)))
        h = (h + 2 * p - k) // s + 1
        w = (w + 2 * p - k) // s + 1
        c = conv.weight.shape[0]
    for i, lin in enumerate(backbone.linears):
        spec.append((f"LipsLinear_{i}", lin, None, None, None))
    return spec


def lfx_init(backbone, input_shape,
             generator: Optional[torch.Generator] = None,
             device=None) -> Optional[Dict[str, torch.Tensor]]:
    """Normal starting vectors per tracked layer: (out,) for a linear,
    (1, ci, h, w) for a conv; None for a backbone with constant 1."""
    spec = lfx_spec(backbone, input_shape)
    if spec is None:
        return None
    return {name: torch.randn((layer.weight.shape[0],) if shp is None
                              else (1, *shp), generator=generator,
                              device=device)
            for name, layer, _, _, shp in spec}


def compute_lfx(backbone, u_state: Optional[Dict[str, torch.Tensor]],
                input_shape, n_iter: int = 1
                ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """(product of the layers' sigma_max estimates, new state), no
    gradient; (1, None) without a state."""
    if u_state is None:
        return torch.tensor(1.0), None
    Lfx, new = None, {}
    with torch.no_grad():
        for name, layer, s, p, shp in lfx_spec(backbone, input_shape):
            W = layer.weight.detach()
            if shp is None:
                sigma, u = power_iteration_dense(W, u_state[name], n_iter)
            else:
                sigma, u = power_iteration_conv(W, shp, u_state[name], n_iter,
                                                stride=s, padding=p)
            Lfx = sigma if Lfx is None else Lfx * sigma
            new[name] = u
    return Lfx, new
