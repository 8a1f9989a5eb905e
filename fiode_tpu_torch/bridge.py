"""Load the JAX package's parameters into the port's modules.

The JAX params are a nested dict of arrays with flax names, e.g.::

    {"backbone": {"CayleyConv_0": {"weight", "alpha", "bias"}, ...,
                  "CayleyLinear_2": {...}},
     "dynamics": {"hidden_to_mlp": {...}, "U_x": {...}, "mlp_to_mlp": {...},
                  "mlp_to_hidden": {...}}}

Both packages keep one layout ((out, in) linears, (co, ci, k, k) convs), so
loading renames and copies, and never transposes.
"""
from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

__all__ = ["params_from_numpy"]

# flax auto-named submodules -> the port's ModuleLists
_LISTS = {"CayleyConv": "convs", "CayleyLinear": "linears",
          "LipsLinear": "linears"}
# flax leaf names -> the port's parameter names
_LEAVES = {"kernel": "weight"}


def _port_name(path) -> str:
    out = []
    for part in path:
        m = re.fullmatch(r"([A-Za-z]+)_(\d+)", part)
        if m and m.group(1) in _LISTS:
            out += [_LISTS[m.group(1)], m.group(2)]
        else:
            out.append(part)
    out[-1] = _LEAVES.get(out[-1], out[-1])
    return ".".join(out)


def _flatten(tree: Mapping[str, Any], prefix=()):
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _flatten(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def params_from_numpy(model: nn.Module, tree: Mapping[str, Any]) -> nn.Module:
    """Copy a JAX params tree (numpy arrays) into ``model`` in place; every
    parameter must be matched.  Returns ``model``."""
    state = {
        _port_name(path): torch.from_numpy(np.array(val, dtype=np.float32))
        for path, val in _flatten(tree)
    }
    model.load_state_dict(state, strict=True)
    return model
