"""Control state-space samplers: cubes, polytopes, grids, rejection, and the
barrier-face grid samplers (counterpart of
the JAX package's ``control/samplers.py``).

The random samplers draw from an explicit ``torch.Generator`` on its
device; the grid builders and face samplers are numpy, bit-equal to the JAX
package's; ``reject_sampling`` evaluates V on the device the Lyapunov
function lives on.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
import torch

__all__ = [
    "random_uniform",
    "random_uniform_extend",
    "random_polytope",
    "random_polytope_clipv",
    "reject_sampling",
    "grid_uniform_2d",
    "grid_uniform_3d",
    "grid_uniform_4d",
    "SamplingPhiPhiDot",
    "SamplingPhiV",
    "SamplingPhiDotV",
    "SamplingV",
]


def _device(generator: Optional[torch.Generator], sizes):
    if generator is not None:
        return generator.device
    return sizes.device if isinstance(sizes, torch.Tensor) else torch.device("cpu")


def _rand(shape, generator, device):
    return torch.rand(shape, generator=generator, device=device)


def random_uniform(sizes, batch_size, generator=None):
    """(batch_size, len(sizes)) uniform in [-sizes, sizes]."""
    device = _device(generator, sizes)
    sizes = torch.as_tensor(sizes, dtype=torch.float32, device=device)
    u = 2.0 * _rand((batch_size, sizes.shape[0]), generator, device) - 1.0
    return u * sizes


def random_uniform_extend(sizes, batch_size, alpha_1=1.0, margin=0.0,
                          generator=None):
    device = _device(generator, sizes)
    tmp = random_uniform(sizes, batch_size, generator)
    phi = tmp[:, 2:3]
    ub = alpha_1 * (math.pi / 12 - phi) + margin
    lb = -alpha_1 * (math.pi / 12 + phi) - margin
    phi_dot = (ub - lb) * _rand((batch_size, 1), generator, device) + lb
    return torch.cat([tmp, phi_dot], dim=1)


def _polytope_phi(sizes, batch_size, alphas, margin, generator):
    device = _device(generator, sizes)
    phi = random_uniform(sizes, batch_size, generator)
    ub = alphas[0] * (math.pi / 12 - phi) + margin
    lb = -alphas[0] * (math.pi / 12 + phi) - margin
    phi_dot = (ub - lb) * _rand((batch_size, 1), generator, device) + lb
    return phi, phi_dot, device


def random_polytope(sizes, batch_size, alphas=(10.0, 0.1, 2.0), margin=0.0,
                    generator=None):
    phi, phi_dot, device = _polytope_phi(sizes, batch_size, alphas, margin,
                                         generator)
    lb_v = torch.maximum(1 / alphas[1] * phi - 3.0,
                         -1 / alphas[2] * phi_dot - 2.25) + margin
    ub_v = torch.minimum(1 / alphas[1] * phi + 3.0,
                         -1 / alphas[2] * phi_dot + 2.25) + margin
    v = _rand(phi.shape, generator, device) * (ub_v - lb_v) + lb_v
    return torch.cat([phi, v, phi_dot], dim=1)


def random_polytope_clipv(sizes, batch_size, alphas=(10.0, 0.1, 2.0),
                          margin=0.0, generator=None):
    phi, phi_dot, device = _polytope_phi(sizes, batch_size, alphas, margin,
                                         generator)
    lb_v = torch.clamp(torch.maximum(1 / alphas[1] * phi - 3.0,
                                     -1 / alphas[2] * phi_dot - 2.25),
                       min=-2.5 - margin)
    ub_v = torch.clamp(torch.minimum(1 / alphas[1] * phi + 3.0,
                                     -1 / alphas[2] * phi_dot + 2.25),
                       max=2.5 + margin)
    v = _rand(phi.shape, generator, device) * (ub_v - lb_v) + lb_v
    return torch.cat([phi, v, phi_dot], dim=1)


def reject_sampling(x, lya, level_lb, level_ub, return_mask=False):
    """Keep the states whose V lies in [level_lb, level_ub], evaluated on
    the device of ``lya.P``; returns a tensor there (and the mask)."""
    x = torch.as_tensor(x, dtype=torch.float32, device=lya.P.device)
    with torch.no_grad():
        val = lya(x)[:, 0]
    mask = (val >= level_lb) & (val <= level_ub)
    if return_mask:
        return x[mask], mask
    return x[mask]


def grid_uniform_2d(sizes, r):
    d0 = np.arange(-sizes[0], sizes[0], r[0])
    d1 = np.arange(-sizes[1], sizes[1], r[1])
    a, b = np.meshgrid(d0, d1)
    grid = np.stack([a.reshape(-1), b.reshape(-1)], axis=1).astype(np.float32)
    return grid, a, b


def grid_uniform_3d(sizes, r):
    d = [np.arange(-s, s, ri) for s, ri in zip(sizes, r)]
    a, b, c = np.meshgrid(*d)
    grid = np.stack(
        [a.reshape(-1), b.reshape(-1), c.reshape(-1)], axis=1
    ).astype(np.float32)
    return grid, a, b, c


def grid_uniform_4d(sizes, r):
    d = [np.arange(-s, s, ri) for s, ri in zip(sizes, r)]
    m = np.meshgrid(*d)
    grid = np.stack([g.reshape(-1) for g in m], axis=1).astype(np.float32)
    return (grid, *m)


def _face_mask(grid, alphas):
    """Membership in the polytope (the mask shared by all face samplers)."""
    phi, v, phi_dot = grid[:, 0:1], grid[:, 1:2], grid[:, 2:3]
    return (
        (phi_dot >= -alphas[0] * (phi + np.pi / 12))
        & (phi_dot <= -alphas[0] * (phi - np.pi / 12))
        & (phi >= alphas[1] * (v - 3.0))
        & (phi <= alphas[1] * (v + 3.0))
        & (phi_dot >= -alphas[2] * (v + 2.25))
        & (phi_dot <= -alphas[2] * (v - 2.25))
        & (v >= -2.5)
        & (v <= 2.5)
    )[:, 0]


@dataclasses.dataclass
class _FaceSampler:
    alphas: Sequence[float]
    rs: Sequence[float]
    side: str = "lb"


class SamplingPhiPhiDot(_FaceSampler):
    """Grid on the face phi_dot = -a0 (phi ± pi/12)."""

    def __call__(self):
        sign = 1.0 if self.side == "lb" else -1.0
        phi = np.arange(-np.pi / 12, np.pi / 12, self.rs[0])[:, None]
        phi_dot = -self.alphas[0] * (phi + sign * np.pi / 12)
        lb_v = np.clip(
            np.maximum(1 / self.alphas[1] * phi - 3.0,
                       -1 / self.alphas[2] * phi_dot - 2.25),
            -2.5, None,
        )
        ub_v = np.clip(
            np.minimum(1 / self.alphas[1] * phi + 3.0,
                       -1 / self.alphas[2] * phi_dot + 2.25),
            None, 2.5,
        )
        v = np.arange(lb_v.min(), ub_v.max(), self.rs[1])[:, None]
        nv = len(v)
        grid = np.concatenate(
            [
                np.repeat(phi, nv, 0),
                np.tile(v, (len(phi), 1)),
                np.repeat(phi_dot, nv, 0),
            ],
            axis=1,
        ).astype(np.float32)
        true_grid = grid[_face_mask(grid, self.alphas)]
        true_rs = [self.rs[0], self.rs[1], self.alphas[0] * self.rs[0]]
        return true_grid, true_rs


class SamplingPhiV(_FaceSampler):
    """Face v = phi/a1 ± 3."""

    def __call__(self):
        sign = 1.0 if self.side == "lb" else -1.0
        phi = np.arange(-np.pi / 12, np.pi / 12, self.rs[0])[:, None]
        v = 1 / self.alphas[1] * phi + sign * 3.0
        lb_pd = np.maximum(-self.alphas[0] * (phi + np.pi / 12),
                           -self.alphas[2] * (v + 2.25))
        ub_pd = np.minimum(-self.alphas[0] * (phi - np.pi / 12),
                           -self.alphas[2] * (v - 2.25))
        if lb_pd.min() > ub_pd.max():
            return None, None
        phi_dot = np.arange(lb_pd.min(), ub_pd.max(), self.rs[2])[:, None]
        npd = len(phi_dot)
        grid = np.concatenate(
            [
                np.repeat(phi, npd, 0),
                np.repeat(v, npd, 0),
                np.tile(phi_dot, (len(phi), 1)),
            ],
            axis=1,
        ).astype(np.float32)
        true_grid = grid[_face_mask(grid, self.alphas)]
        true_rs = [self.rs[0], 1 / self.alphas[1] * self.rs[0], self.rs[2]]
        return true_grid, true_rs


class SamplingPhiDotV(_FaceSampler):
    """Face v = -phi_dot/a2 ± 2.25."""

    def __call__(self):
        sign = -1.0 if self.side == "lb" else 1.0
        lim = self.alphas[0] * np.pi / 12 * 2
        phi_dot = np.arange(-lim, lim, self.rs[2])[:, None]
        v = -1 / self.alphas[2] * phi_dot + sign * 2.25
        lb_phi = np.clip(
            np.maximum(-1 / self.alphas[0] * phi_dot - np.pi / 12,
                       self.alphas[1] * (v - 3.0)),
            -np.pi / 12, None,
        )
        ub_phi = np.clip(
            np.minimum(-1 / self.alphas[0] * phi_dot + np.pi / 12,
                       self.alphas[1] * (v + 3.0)),
            None, np.pi / 12,
        )
        phi = np.arange(lb_phi.min(), ub_phi.max(), self.rs[0])[:, None]
        np_ = len(phi)
        grid = np.concatenate(
            [
                np.tile(phi, (len(phi_dot), 1)),
                np.repeat(v, np_, 0),
                np.repeat(phi_dot, np_, 0),
            ],
            axis=1,
        ).astype(np.float32)
        true_grid = grid[_face_mask(grid, self.alphas)]
        true_rs = [self.rs[0], 1 / self.alphas[1] * self.rs[0], self.rs[2]]
        return true_grid, true_rs


class SamplingV(_FaceSampler):
    """Face v = ±2.5."""

    def __call__(self):
        sign = -1.0 if self.side == "lb" else 1.0
        lim = self.alphas[0] * np.pi / 12 * 2
        phi = np.arange(-np.pi / 12, np.pi / 12, self.rs[0])[:, None]
        phi_dot = np.arange(-lim, lim, self.rs[2])[:, None]
        v = np.full_like(phi, sign * 2.5)
        npd = len(phi_dot)
        grid = np.concatenate(
            [
                np.repeat(phi, npd, 0),
                np.repeat(v, npd, 0),
                np.tile(phi_dot, (len(phi), 1)),
            ],
            axis=1,
        ).astype(np.float32)
        true_grid = grid[_face_mask(grid, self.alphas)]
        true_rs = [self.rs[0], 0.0, self.rs[2]]
        return true_grid, true_rs
