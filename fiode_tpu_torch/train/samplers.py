"""State-space samplers for Lyapunov certified training (counterpart of
``fiode_tpu/train/samplers.py``).

Each sampler returns (B, S, n) states h in (or near) the probability
simplex where the Lyapunov decrease condition is enforced.  A sampler is a
transform of its base draws, which ``draw`` makes from a
``torch.Generator`` on the labels' device:

  ========================  =============================================
  sampler                   base draws (the JAX sampler's own calls)
  ========================  =============================================
  UniformSimplexSampling    exponential (B, S, n)
  BandSimplexSampling       exponential (B, S, n), uniform [0.1, 1) (B, S)
  ProjectedBiased...Sphere  uniform [0, sqrt(n) lim) (B, S, 1), normal (B, S, n)
  ProjectedHyperCube...     uniform [-lim, lim) (B, S, n)
  CorrectConeSampling       exponential (B, S, n)
  DecisionBoundarySampling  exponential (B, S, n - 1)
  TrajectorySampler         none: the solved trajectory of the batch
  ========================  =============================================

so a caller (a test) can hand a sampler the draws the JAX package made and
get its states back.

``composite_sample`` mixes samplers: with per-epoch coefficients c, sampler
i owns the slots [sum_{j<i} k_j, sum_{j<=i} k_j) with k_i = floor(S c_i),
the last sampler taking the remainder (the reference's rule).  Every
sampler draws all S slots, as in the JAX package, so its draws do not
depend on the mixture.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
from torch.nn import functional as F

__all__ = ["SAMPLERS", "draw", "composite_sample", "slot_counts",
           "trajectory_sampler"]


def _exponential(shape, generator, device):
    return torch.empty(shape, device=device).exponential_(generator=generator)


def _uniform(shape, lo, hi, generator, device):
    return torch.rand(shape, generator=generator, device=device) * (hi - lo) + lo


def draw(name: str, B: int, n: int, S: int, *, h_dist_lim: float = 15.0,
         generator: Optional[torch.Generator] = None,
         device=None) -> tuple:
    """The base draws of sampler ``name`` for B labels, S slots, n classes."""
    g, d = generator, device
    if name in ("UniformSimplexSampling", "CorrectConeSampling"):
        return (_exponential((B, S, n), g, d),)
    if name == "BandSimplexSampling":
        return (_exponential((B, S, n), g, d), _uniform((B, S), 0.1, 1.0, g, d))
    if name == "ProjectedBiasedHyperSphereSampling":
        r = _uniform((B, S, 1), 0.0, math.sqrt(n * h_dist_lim ** 2), g, d)
        return (r, torch.randn((B, S, n), generator=g, device=d))
    if name == "ProjectedHyperCubeSampling":
        return (_uniform((B, S, n), -h_dist_lim, h_dist_lim, g, d),)
    if name == "DecisionBoundarySampling":
        return (_exponential((B, S, n - 1), g, d),)
    if name == "TrajectorySampler":
        return ()
    raise ValueError(f"unknown sampler {name!r}")


def _simplex(e):
    """Dirichlet(1) samples from Exp(1) draws: e / sum(e)."""
    return e / torch.sum(e, dim=-1, keepdim=True)


def uniform_simplex(y, n, S, e, **_):
    return _simplex(e)


def band_simplex(y, n, S, e, gt, **_):
    """Uniform simplex with the label coordinate replaced by U(0.1, 1) (not
    renormalised, as in the reference)."""
    onehot = F.one_hot(y, n).to(e.dtype)[:, None, :]
    return _simplex(e) * (1 - onehot) + gt[..., None] * onehot


def projected_biased_hypersphere(y, n, S, r, v, **_):
    """softmax(radius * unit normal)."""
    v = v / torch.linalg.norm(v, dim=-1, keepdim=True)
    return torch.softmax(v * r, dim=-1)


def projected_hypercube(y, n, S, v, **_):
    """softmax of L2-normalised U(-lim, lim) logits."""
    v = v / torch.linalg.norm(v, dim=-1, keepdim=True)
    return torch.softmax(v, dim=-1)


def correct_cone(y, n, S, e, **_):
    """Uniform simplex samples with the label coordinate swapped with the
    max: points inside the label's decision cone."""
    h = _simplex(e)
    max_val, max_idx = torch.max(h, dim=-1, keepdim=True)
    lab = y[:, None, None].expand(-1, S, 1)
    lab_val = torch.take_along_dim(h, lab, dim=-1)
    h = h.scatter(-1, max_idx, lab_val)
    return h.scatter(-1, lab, max_val)


def decision_boundary(y, n, S, zs, **_):
    """Samples on the label's decision boundary: p_y ties the largest wrong
    probability."""
    z1 = torch.amax(zs, dim=-1, keepdim=True)
    raw = torch.cat([z1, zs], dim=-1)
    raw = raw / torch.sum(raw, dim=-1, keepdim=True)
    onehot = F.one_hot(y, n).bool()[:, None, :]  # (B, 1, n)
    # the wrong coordinates take raw[..., 1:] in coordinate order
    idx_wrong = (torch.cumsum((~onehot).to(torch.int64), dim=-1) - 1)
    idx_wrong = idx_wrong.clamp(0, n - 2).expand(-1, S, n)
    return torch.where(onehot.expand(-1, S, n), raw[..., 0:1],
                       torch.take_along_dim(raw[..., 1:], idx_wrong, dim=-1))


def trajectory_sampler(y, n, S, *, model=None, x=None, process_group=None,
                       **_):
    """The states of the batch's solved trajectory at S evenly spaced times
    in [0, t_max] (no gradient; the port's output map is the identity, so
    these are the hidden states the JAX sampler takes); ``process_group``
    goes to the solve."""
    if model is None or x is None:
        raise ValueError("TrajectorySampler needs the model and the batch x")
    with torch.no_grad():
        return model.trajectory(x, S, process_group=process_group).transpose(0, 1)


SAMPLERS: Dict[str, Callable] = {
    "UniformSimplexSampling": uniform_simplex,
    "BandSimplexSampling": band_simplex,
    "ProjectedBiasedHyperSphereSampling": projected_biased_hypersphere,
    "ProjectedHyperCubeSampling": projected_hypercube,
    "CorrectConeSampling": correct_cone,
    "DecisionBoundarySampling": decision_boundary,
    "TrajectorySampler": trajectory_sampler,
}


def slot_counts(coefficients, S: int) -> np.ndarray:
    """Slots per sampler: floor(S c_i) in float32, the remainder to the
    last."""
    c = np.asarray(coefficients, np.float32)
    counts = np.floor(np.float32(S) * c).astype(np.int64)
    counts[-1] = S - counts[:-1].sum()
    return counts


def composite_sample(sampler_names: Sequence[str], coefficients, y, n: int,
                     S: int, *, h_dist_lim: float = 15.0,
                     generator: Optional[torch.Generator] = None,
                     draws: Optional[Sequence[tuple]] = None,
                     **extra) -> torch.Tensor:
    """Mix the samplers by the coefficients (``slot_counts``); each draws
    from ``generator`` in order, unless ``draws`` gives every sampler's base
    draws.  ``extra`` (model, x) reaches the TrajectorySampler.  Returns
    (B, S, n)."""
    counts = slot_counts(coefficients, S)
    parts, start = [], 0
    for i, name in enumerate(sampler_names):
        d = draws[i] if draws is not None else draw(
            name, y.shape[0], n, S, h_dist_lim=h_dist_lim,
            generator=generator, device=y.device)
        h = SAMPLERS[name](y, n, S, *d, **extra)
        parts.append(h[:, start:start + counts[i]])
        start += counts[i]
    return torch.cat(parts, dim=1)
