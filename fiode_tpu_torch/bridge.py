"""Load the JAX package's parameters into the port's modules.

The JAX params are a nested dict of arrays with flax names, e.g.::

    {"backbone": {"CayleyConv_0": {"weight", "alpha", "bias"}, ...,
                  "CayleyLinear_2": {...}},
     "dynamics": {"hidden_to_mlp": {...}, "U_x": {...}, "mlp_to_mlp": {...},
                  "mlp_to_hidden": {...}}}

Both packages keep one layout ((out, in) linears, (co, ci, k, k) convs) for
the classifier's layers, so loading them renames and copies.  Where the JAX
package has flax's own layers, loading changes the layout: the legacy conv
dynamics' ``nn.Conv`` kernels (HWIO to OIHW), ``nn.Dense`` kernels ((in,
out) to (out, in)) and ``GroupNorm`` scales (``weight`` here).  A cached
Cayley conv's complex64 Q (n, nf, co, ci) becomes the float32 pair ``Qr``,
``Qi`` (F, co, ci), F = n nf; the "linear" output's kernel is
``output.weight``.

A checkpoint crosses as a flat ``.npz`` whose keys are the flax names joined
by ``/`` (``backbone/CayleyConv_0/weight``), float32 arrays and nothing
pickled: ``load_npz`` reads one into a model, ``save_npz`` writes a model's
parameters under the same names.  ``tools/export_torch_checkpoint.py`` makes
such a file from an orbax checkpoint of the JAX package.
``params_to_numpy`` is the inverse of ``params_from_numpy``: a model's
parameters as the flax-named tree of numpy arrays.

The Segway controller crosses the same way: ``segway_from_numpy`` takes the
JAX package's trained controller (``{"ctrl": {"Dense_0": {"kernel",
"bias"}, "Dense_1": ...}, "P": ...}``, flax kernels (in, out)) to an
``NNController`` and P on a device, ``segway_to_numpy`` back.
"""
from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

__all__ = ["params_from_numpy", "params_to_numpy", "load_npz", "save_npz",
           "segway_from_numpy", "segway_to_numpy"]

# flax auto-named submodules -> the port's ModuleLists
_LISTS = {"CayleyConv": "convs", "CayleyLinear": "linears",
          "LipsConv": "convs", "LipsLinear": "linears"}
# flax leaf names -> the port's parameter names
_LEAVES = {"kernel": "weight", "scale": "weight"}
# the port's layers whose flax counterpart calls its weight "kernel"
_KERNEL_LAYERS = ("LipsLinear", "LipsConv", "LinearOutput")
# flax paths the port names otherwise (the legacy dynamics' stem)
_PATHS = {("stem", "inner", "layers_0"): ("stem",)}


def _port_name(path) -> str:
    path = tuple(path)
    for flax, port in _PATHS.items():
        if path[-len(flax) - 1:-1] == flax:
            path = path[:-len(flax) - 1] + port + path[-1:]
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


def _owner(model: nn.Module, name: str) -> nn.Module:
    return model.get_submodule(name.rpartition(".")[0])


def _port_tensors(model: nn.Module, path, val):
    """The port's (name, float32 tensor) pairs for one flax leaf: a cached
    conv's complex Q (n, nf, co, ci) becomes Qr and Qi (F, co, ci); a
    legacy conv's HWIO kernel becomes OIHW; a flax Dense's (in, out) kernel
    becomes (out, in); everything else keeps its layout."""
    name = _port_name(path)
    val = np.asarray(val)
    if np.iscomplexobj(val):
        base = name[:-1]  # the prefix of the leaf "Q"
        q = val.reshape((-1,) + val.shape[-2:])
        return [(f"{base}Qr", torch.from_numpy(q.real.astype(np.float32))),
                (f"{base}Qi", torch.from_numpy(q.imag.astype(np.float32)))]
    t = torch.from_numpy(np.array(val, dtype=np.float32))
    if path[-1] == "kernel":
        kind = type(_owner(model, name)).__name__
        if kind == "_Conv":
            t = t.permute(3, 2, 0, 1).contiguous()
        elif kind == "Linear":
            t = t.T.contiguous()
    return [(name, t)]


def params_from_numpy(model: nn.Module, tree: Mapping[str, Any]) -> nn.Module:
    """Copy a JAX params tree (numpy arrays) into ``model`` in place; every
    parameter must be matched.  Returns ``model``."""
    state = dict(pair for path, val in _flatten(tree)
                 for pair in _port_tensors(model, path, val))
    model.load_state_dict(state, strict=True)
    return model


def _unflatten(flat: Mapping[str, Any]) -> dict:
    tree: dict = {}
    for key, val in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = val
    return tree


def load_npz(model: nn.Module, path) -> nn.Module:
    """Copy the parameters stored in the flat ``.npz`` at ``path`` (flax names
    joined by ``/``) into ``model`` in place; every parameter must be
    matched.  Returns ``model``, on the device it was on."""
    with np.load(path, allow_pickle=False) as flat:
        tree = _unflatten({key: flat[key] for key in flat.files})
    return params_from_numpy(model, tree)


def _flax_name(model: nn.Module, name: str) -> str:
    """The ``/``-joined flax name of the port's parameter ``name``."""
    *parents, leaf = name.split(".")
    out, mod, i = [], model, 0
    while i < len(parents):
        child = getattr(mod, parents[i])
        if isinstance(child, nn.ModuleList):
            child = child[int(parents[i + 1])]
            out.append(f"{type(child).__name__}_{parents[i + 1]}")
            i += 2
        else:
            out.append(parents[i])
            i += 1
        mod = child
    kind = type(mod).__name__
    if leaf == "weight" and kind in _KERNEL_LAYERS + ("_Conv", "Linear"):
        leaf = "kernel"
    elif leaf == "weight" and kind == "GroupNorm":
        leaf = "scale"
    elif leaf in ("Qr", "Qi"):
        leaf = "Q"
    for flax, port in _PATHS.items():
        if tuple(out[-len(port):]) == port:
            out = out[:-len(port)] + list(flax)
    return "/".join(out + [leaf])


def _flat_numpy(model: nn.Module) -> dict:
    """The inverse of ``_port_tensors`` over every parameter of ``model``."""
    flat = {}
    for name, p in model.named_parameters():
        a = p.detach().cpu().numpy()
        mod = _owner(model, name)
        kind = type(mod).__name__
        leaf = name.rpartition(".")[2]
        if leaf == "Qi":
            continue
        if leaf == "Qr":
            n = mod.n
            a = (a + 1j * mod.Qi.detach().cpu().numpy()).astype(np.complex64)
            a = a.reshape((n, n // 2 + 1) + a.shape[1:])
        elif kind == "_Conv":
            a = a.transpose(2, 3, 1, 0)
        elif kind == "Linear" and leaf == "weight":
            a = a.T
        flat[_flax_name(model, name)] = a.copy(order="C")
    return flat


def params_to_numpy(model: nn.Module) -> dict:
    """``model``'s parameters as the JAX package's nested params tree of
    float32 (a cached conv's Q: complex64) numpy arrays, the inverse of
    ``params_from_numpy``."""
    return _unflatten(_flat_numpy(model))


def save_npz(model: nn.Module, path) -> None:
    """Write ``model``'s parameters to ``path`` as a flat ``.npz`` under their
    flax names, the file ``load_npz`` and the JAX package's params tree
    agree on."""
    np.savez(path, **_flat_numpy(model))


def segway_from_numpy(tree: Mapping[str, Any], device="cuda"):
    """(NNController, P) on ``device`` from the JAX package's Segway
    controller tree; the widths are read from the kernels."""
    from .control.controllers import NNController

    dense = tree["ctrl"]
    k0, k1 = (np.asarray(dense[f"Dense_{i}"]["kernel"], np.float32) for i in (0, 1))
    ctrl = NNController(k0.shape[0], k1.shape[1], k0.shape[1])
    with torch.no_grad():
        for i, k in enumerate((k0, k1)):
            layer = getattr(ctrl, f"Dense_{i}")
            layer.weight.copy_(torch.from_numpy(k.T.copy()))
            layer.bias.copy_(torch.from_numpy(
                np.array(dense[f"Dense_{i}"]["bias"], np.float32)))
    P = torch.as_tensor(np.array(tree["P"], np.float32), device=device)
    return ctrl.to(device), P


def segway_to_numpy(ctrl: nn.Module, P: torch.Tensor) -> dict:
    """The JAX package's Segway controller tree ``{"ctrl": ..., "P": ...}``
    of float32 numpy arrays (kernels in flax's (in, out) layout)."""
    dense = {}
    for i in (0, 1):
        layer = getattr(ctrl, f"Dense_{i}")
        dense[f"Dense_{i}"] = {
            "kernel": layer.weight.detach().cpu().numpy().T.copy(),
            "bias": layer.bias.detach().cpu().numpy()}
    return {"ctrl": dense, "P": P.detach().cpu().numpy()}
