"""Segway safe-controller certification and closed-loop simulation
(counterpart of the JAX package's ``control/certify_segway.py``):

  * the level band inflated by the grid resolution,
    level_{ub,lb} = (sqrt(level) ± sqrt(3)/2 · r · sigma_max(P))^2;
  * a sound bound of Vdot over every grid cell in the band: CROWN bounds of
    the ReLU controller over the cell's Linf box (half-width r/2,
    ``verify/crown.py``) feed an interval enclosure of the analytic
    closed-loop dynamics (``Segway.dynamics_interval``), then an interval
    quadratic form for Vdot = <PᵀP x, f>; certified iff the largest upper
    bound is <= 0.  The exact Vdot at the cell centres separates "training
    failed" (exact > 0) from "bound too loose" (exact <= 0 < ub);
  * closed-loop trajectories from starts just inside the level set.

The grid is built on the device one slab of its outermost axis (v) at a
time, so a fine grid (r = 0.0025: 302 M states) never exists whole; the
cells kept are the JAX package's, in its order.  Everything runs with TF32
off (``float32_matmuls``): the interval products are sound in float32 only.
"""
from __future__ import annotations

import dataclasses
import math
from collections.abc import Mapping
from typing import Optional

import numpy as np
import torch

from ..bridge import segway_from_numpy
from ..verify.certify import float32_matmuls
from ..verify.crown import crown_mlp_bounds
from ..verify.interval import IV, iv_dot
from .lyapunov_ctrl import LyaQuadratic
from .samplers import random_uniform, reject_sampling
from .systems import Segway
from .train_segway import load_segway

__all__ = ["certify_segway", "SegwayCertifyResult", "vdot_cell_bounds",
           "band_cells", "grid_slabs"]

SLAB_STATES = 1 << 23  # grid states built and tested per slab


@dataclasses.dataclass
class SegwayCertifyResult:
    ub_max: float
    certified: bool
    n_cells: int
    level_lb: float
    level_ub: float
    exact_vdot_max: float = float("nan")
    traj_max_level_drift: Optional[float] = None


def vdot_cell_bounds(system, ctrl_Ws, ctrl_bs, P, cells, half_width):
    """(lower, upper) bound of Vdot over the Linf boxes around ``cells``
    (N, 3)."""
    # 1. controller output bounds by CROWN over the cell box
    u_lb, u_ub = crown_mlp_bounds(
        ctrl_Ws, ctrl_bs, cells, half_width,
        torch.zeros(ctrl_bs[0].shape[-1], device=cells.device))
    # 2. the closed-loop dynamics' interval
    x_iv = IV(cells - half_width, cells + half_width)
    f_iv = system.dynamics_interval(x_iv, IV(u_lb, u_ub))
    # 3. Vdot = <PᵀP x, f>; g = PᵀP x by the sign-split interval matvec
    # (a trained P has mixed-sign rows of PᵀP, where two box corners
    # under-cover)
    g_iv = iv_dot(x_iv, P.T @ P)
    prod = g_iv * f_iv
    return prod.lo.sum(-1), prod.hi.sum(-1)


def grid_slabs(sizes, r, device):
    """The states of ``grid_uniform_3d(sizes, r)`` in its order, as (n, 3)
    tensors on ``device``, a slab of v values at a time (numpy's meshgrid
    puts v outermost, then phi, then phi_dot)."""
    d = [torch.from_numpy(np.arange(-s, s, r).astype(np.float32)).to(device)
         for s in sizes]
    n_phi, n_v, n_pd = (len(a) for a in d)
    step = max(1, SLAB_STATES // (n_phi * n_pd))
    for j in range(0, n_v, step):
        vs = d[1][j:j + step]
        shape = (len(vs), n_phi, n_pd)
        yield torch.stack([d[0].view(1, -1, 1).expand(shape),
                           vs.view(-1, 1, 1).expand(shape),
                           d[2].view(1, 1, -1).expand(shape)], dim=-1).reshape(-1, 3)


def band_cells(lya, level_lb, level_ub, r, sizes):
    """The states of ``grid_uniform_3d(sizes, r)`` whose V lies in
    [level_lb, level_ub], in the grid's order, as an (n, 3) tensor on the
    device of ``lya.P``."""
    return torch.cat([reject_sampling(slab, lya, level_lb, level_ub)
                      for slab in grid_slabs(sizes, r, lya.P.device)])


def _load(model_path, model, device):
    """(NNController, P) on ``device`` from a path to the port's ``.npz``, a
    ``train_segway`` / ``load_segway`` result, or the JAX package's tree."""
    if model is None:
        model = load_segway(model_path, device)
    if isinstance(model["ctrl"], Mapping):
        return segway_from_numpy(model, device)
    P = torch.as_tensor(model["P"], dtype=torch.float32).to(device)
    return model["ctrl"].to(device), P.detach()


def certify_segway(
    model_path: Optional[str] = None,
    model: Optional[dict] = None,
    *,
    level: float = 0.15,
    r: float = 0.01,
    region: float = 1.5,
    phi_region: float = float(np.pi / 12),
    chunk: int = 65536,
    simulate_trajectories: bool = True,
    verbose: bool = True,
    plot_dir: Optional[str] = None,
    device="cuda",
) -> SegwayCertifyResult:
    """Certify the controller at ``model_path`` (or ``model``) on
    ``device``; the cells are bounded ``chunk`` at a time.  ``plot_dir``
    gets ``segway_vdot_phase.png`` (Vdot contours, the level band and the
    closed-loop streamlines on the v = 0 slice) and, with the simulated
    trajectories, ``segway_traj3d.png``; without matplotlib it gets
    nothing (``utils/plotting.HAVE_MATPLOTLIB``)."""
    device = torch.device(device)
    system = Segway()
    ctrl, P = _load(model_path, model, device)
    lya = LyaQuadratic(P, torch.zeros(1, 3, device=device))
    Ws, bs = ctrl.dense_weights()

    sigma = lya.sigma_max()
    level_ub = (np.sqrt(level) + np.sqrt(3) / 2 * r * sigma) ** 2
    level_lb = max((np.sqrt(level) - np.sqrt(3) / 2 * r * sigma) ** 2, 0.0)
    sizes = (phi_region, region, region)

    with torch.no_grad(), float32_matmuls():
        eta = band_cells(lya, level_lb, level_ub, r, sizes)
        n_cells = len(eta)
        if n_cells == 0:
            # a certificate over zero states is vacuous, not a pass
            raise ValueError(
                f"no grid cell lands in the level band [{level_lb:.4f}, "
                f"{level_ub:.4f}] at r={r}; refine the grid or widen the band")
        ub_max = torch.tensor(-math.inf, device=device)
        exact_max = torch.tensor(-math.inf, device=device)
        for i in range(0, n_cells, chunk):
            blk = eta[i:i + chunk]
            _, ub = vdot_cell_bounds(system, Ws, bs, P, blk, r / 2)
            exact = lya.h_dot(blk, system(blk, ctrl(blk)))[:, 0]
            ub_max = torch.maximum(ub_max, ub.max())
            exact_max = torch.maximum(exact_max, exact.max())
        ub_max, exact_max = (float(v) for v in torch.stack([ub_max, exact_max]).tolist())
        certified = ub_max <= 0.0
        if verbose:
            print(f"[certify_segway] cells={n_cells} ub.max={ub_max:.5f} "
                  f"exact.max={exact_max:.5f} certified={certified}")

        drift = traj = None
        if simulate_trajectories:
            gen = torch.Generator(device).manual_seed(0)
            x0 = random_uniform(sizes, 1000, generator=gen)
            x0_in = reject_sampling(x0, lya, level - 0.02, level)[:5]
            if len(x0_in) > 0:
                ts = np.linspace(0.0, 50.0, 200)
                xs, _ = system.simulate(x0_in, ctrl, ts)
                traj = xs
                levels = lya(xs.reshape(-1, 3)).reshape(xs.shape[:2])
                drift = float(levels.max() - level)
                if verbose:
                    print(f"[certify_segway] {len(x0_in)} trajectories, "
                          f"max level drift above start: {drift:.4f}")
    if plot_dir is not None:
        _plot(plot_dir, system, ctrl, lya, eta, traj, level, level_lb,
              level_ub, phi_region, region, device, verbose)
    return SegwayCertifyResult(
        ub_max=ub_max,
        certified=certified,
        exact_vdot_max=exact_max,
        n_cells=n_cells,
        level_lb=level_lb,
        level_ub=level_ub,
        traj_max_level_drift=drift,
    )


def _plot(plot_dir, system, ctrl, lya, eta, traj, level, level_lb, level_ub,
          phi_region, region, device, verbose):
    """certify_segway's figures under ``plot_dir``."""
    from pathlib import Path

    from ..utils import plotting

    if not plotting.HAVE_MATPLOTLIB:
        if verbose:
            print("[certify_segway] matplotlib is not installed: no figures")
        return
    pdir = Path(plot_dir)
    pdir.mkdir(parents=True, exist_ok=True)
    with float32_matmuls():
        plotting.plot_segway_phase(
            lya, lambda pts: lya.h_dot(pts, system(pts, ctrl(pts)))[:, 0],
            phi_region=phi_region, region=region, level=level,
            level_lb=level_lb, level_ub=level_ub,
            f_fn=lambda pts: system(pts, ctrl(pts)),
            save=str(pdir / "segway_vdot_phase.png"), device=device)
    if traj is not None:
        plotting.plot_segway_traj3d(traj, level_band_pts=eta,
                                    save=str(pdir / "segway_traj3d.png"))
    if verbose:
        print(f"[certify_segway] plots written under {pdir}")
