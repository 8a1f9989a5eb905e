"""Simplex and Segway figures (counterpart of ``fiode_tpu/utils/plotting.py``):
3-class states projected to 2-D (samples and trajectories, the trainer's
per-epoch figures) and the Segway certificate's phase plane and 3-D
trajectories.

matplotlib draws them (the Agg backend, so no display is needed).  Every
function returns ``None`` and writes nothing when matplotlib is not
installed; ``HAVE_MATPLOTLIB`` says which.  Inputs are numpy arrays or
tensors (moved to the host); the Segway phase plot's ``lya``, ``vdot_fn``
and ``f_fn`` are callables on (N, 3) float32 tensors.
"""
from __future__ import annotations

import importlib.util
from typing import Optional

import numpy as np
import torch

__all__ = ["HAVE_MATPLOTLIB", "plot_samples_on_3_simplex",
           "plot_traj_on_3_simplex", "plot_segway_phase", "plot_segway_traj3d"]

HAVE_MATPLOTLIB = importlib.util.find_spec("matplotlib") is not None

# barycentric projection: vertex i of the 3-simplex -> 2-D corner
_TRANSFORM = np.array([[0.0, 0.5, 1.0], [0.0, np.sqrt(3) / 2, 0.0]])


def _pyplot():
    """matplotlib's pyplot on the Agg backend, or None without matplotlib."""
    if not HAVE_MATPLOTLIB:
        return None
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _project(h):
    return _np(h) @ _TRANSFORM.T


def _draw_triangle(ax):
    corners = _project(np.eye(3))
    loop = np.vstack([corners, corners[:1]])
    ax.plot(loop[:, 0], loop[:, 1], "r-", lw=1)


def _finish(plt, fig, save):
    if save:
        fig.savefig(save, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return fig


def plot_samples_on_3_simplex(h_sample, labels=None, save: Optional[str] = None):
    """Scatter of (N, 3) simplex points inside the triangle."""
    plt = _pyplot()
    if plt is None:
        return None
    pts = _project(h_sample)
    fig, ax = plt.subplots(figsize=(5, 4.5))
    if labels is not None:
        sc = ax.scatter(pts[:, 0], pts[:, 1], c=_np(labels), s=6, cmap="tab10")
        fig.colorbar(sc, ax=ax)
    else:
        ax.scatter(pts[:, 0], pts[:, 1], s=6)
    _draw_triangle(ax)
    ax.set_aspect("equal")
    ax.set_title("h samples on the 3-simplex")
    return _finish(plt, fig, save)


def plot_traj_on_3_simplex(traj, labels, save: Optional[str] = None):
    """Trajectories (T, N, 3) coloured by label."""
    plt = _pyplot()
    if plt is None:
        return None
    traj, labels = _np(traj), _np(labels)
    fig, ax = plt.subplots(figsize=(5, 4.5))
    cmap = plt.get_cmap("tab10")
    for i in range(traj.shape[1]):
        pts = _project(traj[:, i])
        ax.plot(pts[:, 0], pts[:, 1], lw=0.8, color=cmap(int(labels[i]) % 10))
        ax.scatter(pts[-1:, 0], pts[-1:, 1], s=14, marker="s",
                   color=cmap(int(labels[i]) % 10))
    _draw_triangle(ax)
    ax.set_aspect("equal")
    ax.set_title("ODE trajectories on the 3-simplex")
    return _finish(plt, fig, save)


def plot_segway_phase(lya, vdot_fn, *, phi_region, region, level, level_lb,
                      level_ub, save: Optional[str] = None, n=80, f_fn=None,
                      device="cpu"):
    """phi x phi_dot contour of Vdot with the level-band curves and (with
    ``f_fn``) the closed-loop streamlines on the v = 0 slice; the callables
    are evaluated on ``device``."""
    plt = _pyplot()
    if plt is None:
        return None
    phi = np.linspace(-phi_region, phi_region, n)
    pd = np.linspace(-region, region, n)
    P, D = np.meshgrid(phi, pd)
    pts = torch.from_numpy(np.stack(
        [P.reshape(-1), np.zeros(P.size), D.reshape(-1)], 1).astype(np.float32)
    ).to(device)
    with torch.no_grad():
        vd = _np(vdot_fn(pts)).reshape(P.shape)
        lv = _np(lya(pts))[:, 0].reshape(P.shape)
        f = None if f_fn is None else _np(f_fn(pts))
    fig, ax = plt.subplots(figsize=(6, 5))
    c1 = ax.contourf(P, D, vd, levels=8, alpha=0.5, cmap="coolwarm")
    if f is not None:
        # state ordering (phi, v, phi_dot): the phase-plane flow is
        # (dphi/dt, dphi_dot/dt) = (f[0], f[2])
        ax.streamplot(P, D, f[:, 0].reshape(P.shape), f[:, 2].reshape(P.shape),
                      color="0.35", density=1.0, linewidth=0.6, arrowsize=0.8)
    ax.contour(P, D, lv, [level], colors="k")
    ax.contour(P, D, lv, [level_lb, level_ub], colors="k",
               linestyles="dashed", linewidths=1.0)
    fig.colorbar(c1, ax=ax)
    ax.set_xlabel(r"$\phi$")
    ax.set_ylabel(r"$\dot\phi$")
    ax.set_title(r"$\dot V$ on the $v=0$ slice; level band dashed")
    return _finish(plt, fig, save)


def plot_segway_traj3d(xs, level_band_pts=None, save: Optional[str] = None):
    """3-D closed-loop trajectories (T, N, 3) with an optional scatter of
    the band's cells (at most ~2000 drawn)."""
    plt = _pyplot()
    if plt is None:
        return None
    xs = _np(xs)
    fig = plt.figure(figsize=(6, 5))
    ax = fig.add_subplot(projection="3d")
    if level_band_pts is not None:
        pts = _np(level_band_pts)
        if len(pts) > 2000:
            pts = pts[:: max(1, len(pts) // 2000)]
        ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=1, alpha=0.08,
                   color="tab:gray", label="certified band cells")
    cmap = plt.get_cmap("tab10")
    for i in range(xs.shape[1]):
        ax.plot(xs[:, i, 0], xs[:, i, 1], xs[:, i, 2], lw=1.0, color=cmap(i % 10))
        ax.scatter(*xs[0, i], marker="o", s=20, color=cmap(i % 10))
        ax.scatter(*xs[-1, i], marker="s", s=20, color=cmap(i % 10))
    ax.set_xlabel(r"$\phi$")
    ax.set_ylabel(r"$v$")
    ax.set_zlabel(r"$\dot\phi$")
    ax.set_title("closed-loop trajectories (o start, s end)")
    return _finish(plt, fig, save)
