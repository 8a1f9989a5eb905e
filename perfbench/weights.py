"""Raw parameters drawn from the seed on the device, in one call, and
loaded into the program's model; the reference gets the same tensors.

Each Cayley layer's weight takes the scale of the program's initialiser,
a normal of std sqrt(2 / fan_out) with flax's fan_out (the last axis times
every axis but the last two), and its alpha the weight's Frobenius norm,
as at initialisation; the biases are drawn at std 0.01, so that they
act.  Draws that are not truncated are the one departure from the
program's initialiser; the Cayley map normalises the weight by its own
norm, so only its direction and alpha reach the model.
"""
from __future__ import annotations

import math

import torch

__all__ = ["draw", "load"]

BIAS_STD = 0.01


def draw(shapes: dict, seed: int, device) -> dict:
    """name -> float32 tensor on ``device`` for every (name, shape) of a
    model's parameters, named as its ``state_dict``."""
    sizes = {k: math.prod(s) for k, s in shapes.items() if not k.endswith(".alpha")}
    g = torch.Generator(device).manual_seed(seed)
    z = torch.randn(sum(sizes.values()), generator=g, device=device)
    out, at = {}, 0
    for k, n in sizes.items():
        t = z[at:at + n].view(shapes[k])
        at += n
        if k.endswith(".weight"):
            s = shapes[k]
            fan = s[-1] * math.prod(s[:-2])
            out[k] = t * math.sqrt(2.0 / fan)
        else:
            out[k] = t * BIAS_STD
    for k in shapes:
        if k.endswith(".alpha"):
            out[k] = torch.linalg.norm(out[k[:-len("alpha")] + "weight"])
    return {k: out[k].contiguous() for k in shapes}


def load(model: torch.nn.Module, params: dict) -> None:
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(params[k])
