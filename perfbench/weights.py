"""Raw parameters drawn from the seed on the device, in one call, or read
from a trained checkpoint whose digest is checked, and loaded into the
program's model; the reference gets the same tensors.

Each Cayley layer's weight takes the scale of the program's initialiser,
a normal of std sqrt(2 / fan_out) with flax's fan_out (the last axis times
every axis but the last two), and its alpha the weight's Frobenius norm,
as at initialisation; the biases are drawn at std 0.01, so that they
act.  Draws that are not truncated are the one departure from the
program's initialiser; the Cayley map normalises the weight by its own
norm, so only its direction and alpha reach the model.

A checkpoint is a flat ``.npz`` of float32 arrays under flax's names
joined by ``/`` (``backbone/CayleyConv_0/weight``); ``checkpoint`` maps
them onto the model's parameter names here, without the program's
loader, so that the reference's weights pass through no code under test.
"""
from __future__ import annotations

import hashlib
import io
import math
import re
from pathlib import Path

import numpy as np
import torch

__all__ = ["draw", "checkpoint", "load"]

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


# flax's auto-named submodules -> the model's module lists
LISTS = {"CayleyConv": "convs", "CayleyLinear": "linears"}


def _model_name(flax_name: str) -> str:
    """``backbone/CayleyConv_0/weight`` -> ``backbone.convs.0.weight``."""
    out = []
    for part in flax_name.split("/"):
        m = re.fullmatch(r"([A-Za-z]+)_(\d+)", part)
        out += [LISTS[m.group(1)], m.group(2)] if m and m.group(1) in LISTS \
            else [part]
    return ".".join(out)


def checkpoint(path, sha256: str, shapes: dict, device) -> dict:
    """name -> float32 tensor on ``device``, read from the ``.npz`` at
    ``path``, whose bytes must have the sha256 digest ``sha256`` and whose
    arrays must match ``shapes`` name for name and shape for shape."""
    data = Path(path).read_bytes()
    digest = hashlib.sha256(data).hexdigest()
    if digest != sha256:
        raise ValueError(f"{path}: sha256 {digest}, the configuration "
                         f"states {sha256}")
    with np.load(io.BytesIO(data), allow_pickle=False) as z:
        arrays = {_model_name(k): z[k] for k in z.files}
    got = {k: tuple(a.shape) for k, a in arrays.items()}
    want = {k: tuple(s) for k, s in shapes.items()}
    if got != want:
        raise ValueError(f"{path}: the arrays do not match the model's "
                         f"parameters: only in the file "
                         f"{sorted(set(got.items()) - set(want.items()))}, "
                         f"only in the model "
                         f"{sorted(set(want.items()) - set(got.items()))}")
    if any(a.dtype != np.float32 for a in arrays.values()):
        raise ValueError(f"{path}: an array that is not float32")
    names = list(shapes)
    flat = torch.from_numpy(np.concatenate(
        [arrays[k].ravel() for k in names])).to(device)
    out, at = {}, 0
    for k in names:
        n = math.prod(want[k])
        out[k] = flat[at:at + n].view(want[k])
        at += n
    return out


def load(model: torch.nn.Module, params: dict) -> None:
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(params[k])
