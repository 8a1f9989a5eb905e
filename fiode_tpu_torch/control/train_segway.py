"""Segway safe-controller training: LQR fit, then barrier adversarial
training (counterpart of the JAX package's ``control/train_segway.py``).

  Phase 1: fit the MLP controller to the LQR law by MSE on states in the
    Lyapunov band 0.1 <= V <= 0.2 (a mask over a uniform batch).
  Phase 2: minimise sum relu(Vdot + margin) over the grid's states in the
    band, after a 7-step Linf PGD (eps 0.02) on the states; one Adam over the
    controller (lr 0.01) and the Lyapunov matrix P (lr 0.02); the
    best-loss parameters are kept.

Every random draw comes from one generator on the training device, seeded
with ``cfg.seed``; the controller's initial weights from a CPU generator
with the same seed.  The trained controller is written as a flat ``.npz``
of float32 arrays under flax names (``ctrl/Dense_0/kernel`` in flax's
(in, out) layout, ``ctrl/Dense_0/bias``, ..., ``P``, ``K_lqr``), with
``best_loss`` and the config as a JSON string: nothing pickled, and
``load_segway`` reads it back.
"""
from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..attacks.pgd import pgd_attack
from ..bridge import _flatten, _unflatten, segway_from_numpy, segway_to_numpy
from .controllers import LinearController, NNController, lqr_gain
from .lyapunov_ctrl import LyaQuadratic
from .samplers import grid_uniform_3d, random_uniform
from .systems import Segway

__all__ = ["SegwayTrainConfig", "train_segway", "save_segway", "load_segway"]


@dataclasses.dataclass
class SegwayTrainConfig:
    adv_train: bool = True
    eps: float = 0.02
    level_lb: float = 0.1
    level_ub: float = 0.2
    region: float = 1.5
    phi_region: float = float(np.pi / 12)
    batch_size: int = 512
    fit_lqr_iters: int = 300
    barrier_iters: int = 300
    grid_r: float = 0.02
    lr_ctrl: float = 0.01
    lr_P: float = 0.02
    margin: float = 0.01
    seed: int = 0
    hidden: int = 32


def save_segway(path, result: dict) -> None:
    """Write a trained controller (``train_segway``'s result) to ``path``
    exactly (no suffix added)."""
    tree = segway_to_numpy(result["ctrl"], result["P"])
    flat = {"/".join(k): np.asarray(v, np.float32) for k, v in _flatten(tree)}
    with open(path, "wb") as fh:
        np.savez(fh, **flat, K_lqr=np.asarray(result["K_lqr"], np.float32),
                 best_loss=np.float64(result["best_loss"]),
                 config=np.array(json.dumps(result["config"], sort_keys=True)))


def load_segway(path, device="cuda") -> dict:
    """Read a controller written by ``save_segway`` (or by
    tools/export_segway_reference.py): ``{"ctrl": NNController, "P",
    "config", "K_lqr", "best_loss"}`` with the module and P on ``device``."""
    with np.load(path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    config = json.loads(str(flat.pop("config")))
    best_loss = float(flat.pop("best_loss"))
    K = flat.pop("K_lqr")
    ctrl, P = segway_from_numpy(_unflatten(flat), device)
    return {"ctrl": ctrl, "P": P, "config": config, "K_lqr": K,
            "best_loss": best_loss}


_SYSTEM = Segway()


def _band_mask(P, eta, cfg):
    """1 where V = |P x|^2 lies in [cfg.level_lb, cfg.level_ub], else 0."""
    v = LyaQuadratic(P, P.new_zeros(1, 3))(eta)[:, 0]
    return ((v >= cfg.level_lb) & (v <= cfg.level_ub)).to(eta.dtype)


def _fit_loss(ctrl, lqr, eta, cfg):
    """Phase 1's objective: the MSE to the LQR law over the batch's states
    in the band of V = |x|^2."""
    mask = _band_mask(torch.eye(3, device=eta.device), eta, cfg)
    per = torch.sum((ctrl(eta) - lqr(eta)) ** 2, dim=-1)
    return torch.sum(per * mask) / torch.clamp_min(torch.sum(mask), 1.0)


def _vdot(ctrl, P, eta):
    """Vdot of V = |P x|^2 along the closed loop."""
    return LyaQuadratic(P, P.new_zeros(1, 3)).h_dot(eta, _SYSTEM(eta, ctrl(eta)))[:, 0]


def _barrier_loss(ctrl, P, eta, mask, cfg):
    """Phase 2's objective: sum relu(Vdot + margin) over the masked states."""
    return torch.sum(torch.relu(_vdot(ctrl, P, eta) + cfg.margin) * mask)


def _adversarial(ctrl, P, grid, mask, cfg, generator, rand_init=True):
    """The 7-step Linf PGD on the states against phase 2's objective."""
    P = P.detach()
    return pgd_attack(
        lambda eta: torch.relu(_vdot(ctrl, P, eta) + cfg.margin) * mask,
        grid, eps=cfg.eps, norm="Linf", steps=7, step_size=2.5 * cfg.eps / 7,
        rand_init=rand_init, clip_min=-2 * math.pi, clip_max=2 * math.pi,
        generator=generator)


def _barrier_adam(ctrl, P, cfg):
    """One Adam over the controller (lr_ctrl) and P (lr_P)."""
    return torch.optim.Adam([{"params": list(ctrl.parameters()), "lr": cfg.lr_ctrl},
                             {"params": [P], "lr": cfg.lr_P}])


def train_segway(cfg: SegwayTrainConfig = SegwayTrainConfig(),
                 save_path: Optional[str] = None, verbose: bool = True,
                 resume: bool = False, checkpoint_every: int = 50,
                 device="cuda"):
    """Train on ``device``.  Every ``checkpoint_every`` iterations the whole
    state (phase, iteration, parameters, optimizer, best copy, generator) is
    written to ``save_path + '.resume.pt'``; ``resume=True`` continues from
    it and replays the uninterrupted run bit for bit."""
    device = torch.device(device)
    resume_path = (save_path + ".resume.pt") if save_path else None
    st = None
    if resume and resume_path and Path(resume_path).exists():
        # generator states are CPU byte tensors: load there, copy into place
        st = torch.load(resume_path, map_location="cpu", weights_only=True)
    K, _ = lqr_gain(_SYSTEM, np.zeros((1, 3)), 10.0 * np.eye(3), np.eye(1))
    lqr = LinearController(K)
    ctrl = NNController.create(torch.Generator().manual_seed(cfg.seed), 3, 1,
                               cfg.hidden).to(device)
    gen = torch.Generator(device).manual_seed(cfg.seed)
    sizes = torch.tensor([cfg.phi_region, cfg.region, cfg.region],
                         device=device)

    def save_resume(state):
        if resume_path and checkpoint_every:
            torch.save({**state, "gen": gen.get_state()}, resume_path)

    # ---- phase 1: fit LQR inside the band (masked MSE) ----------------------

    opt1 = torch.optim.Adam(ctrl.parameters(), lr=cfg.lr_ctrl)

    def fit_step():
        loss = _fit_loss(ctrl, lqr, random_uniform(sizes, cfg.batch_size,
                                                   generator=gen), cfg)
        opt1.zero_grad(set_to_none=True)
        loss.backward()
        opt1.step()
        return loss.detach()

    p1_start, l1 = 0, None
    if st is not None and st["phase"] == 1:
        ctrl.load_state_dict(st["ctrl"])
        opt1.load_state_dict(st["opt1"])
        gen.set_state(st["gen"])
        p1_start = int(st["i"])
        if verbose:
            print(f"[segway] resumed phase 1 at iter {p1_start}")
    if st is None or st["phase"] == 1:
        for i in range(p1_start, cfg.fit_lqr_iters):
            l1 = fit_step()
            if checkpoint_every and (i + 1) % checkpoint_every == 0:
                save_resume({"phase": 1, "i": i + 1, "ctrl": ctrl.state_dict(),
                             "opt1": opt1.state_dict()})
        if verbose and l1 is not None:
            print(f"[segway] LQR fit loss: {float(l1):.5f}")

    # ---- phase 2: barrier training over the banded grid ---------------------

    # float32 sizes, as the JAX package passes them: the same grid points
    grid, *_ = grid_uniform_3d(sizes.cpu().numpy(), np.full(3, cfg.grid_r))
    grid = torch.from_numpy(grid).to(device)
    P = torch.nn.Parameter(torch.eye(3, device=device))
    opt2 = _barrier_adam(ctrl, P, cfg)

    def barrier_step():
        with torch.no_grad():
            mask = _band_mask(P, grid, cfg)
        eta_in = (_adversarial(ctrl, P, grid, mask, cfg, gen) if cfg.adv_train
                  else grid)
        loss = _barrier_loss(ctrl, P, eta_in, mask, cfg)
        opt2.zero_grad(set_to_none=True)
        loss.backward()
        opt2.step()
        return loss.detach()

    @torch.no_grad()
    def worst_vdot():
        # a whole extra grid forward: only at the logging cadence
        vd = _vdot(ctrl, P, grid)
        return torch.max(torch.where(_band_mask(P, grid, cfg) > 0, vd, -math.inf))

    def snapshot():
        return {"ctrl": {k: v.detach().clone() for k, v in ctrl.state_dict().items()},
                "P": P.detach().clone()}

    best_loss, best = math.inf, snapshot()
    p2_start = 0
    if st is not None and st["phase"] == 2:
        ctrl.load_state_dict(st["ctrl"])
        with torch.no_grad():
            P.copy_(st["P"])
        opt2.load_state_dict(st["opt2"])
        gen.set_state(st["gen"])
        best_loss = float(st["best_loss"])
        best = {"ctrl": {k: v.to(device) for k, v in st["best_ctrl"].items()},
                "P": st["best_P"].to(device)}
        p2_start = int(st["i"])
        if verbose:
            print(f"[segway] resumed phase 2 at iter {p2_start}")
    for i in range(p2_start, cfg.barrier_iters):
        loss = float(barrier_step())
        if loss < best_loss:
            best_loss, best = loss, snapshot()
        if verbose and i % 50 == 0:
            print(f"[segway] iter {i}: loss={loss:.5f} "
                  f"worst_vdot={float(worst_vdot()):.5f}")
        if checkpoint_every and (i + 1) % checkpoint_every == 0:
            save_resume({"phase": 2, "i": i + 1, "ctrl": ctrl.state_dict(),
                         "P": P.detach(), "opt2": opt2.state_dict(),
                         "best_loss": best_loss, "best_ctrl": best["ctrl"],
                         "best_P": best["P"]})

    best_ctrl = NNController(3, 1, cfg.hidden).to(device)
    best_ctrl.load_state_dict(best["ctrl"])
    result = {
        "ctrl": best_ctrl,
        "P": best["P"],
        "config": dataclasses.asdict(cfg),
        "K_lqr": np.asarray(K),
        "best_loss": best_loss,
    }
    if save_path:
        save_segway(save_path, result)
    if verbose:
        print(f"[segway] best barrier loss: {best_loss:.5f}")
    return result
