"""Constructors and runners (counterpart of ``fiode_tpu/experiment.py``).

``build_model``, ``build_trainer`` and ``run_train`` take the composed config
dict their JAX twins take (``utils/config.compose``) and train on the card
unless given ``device="cpu"``; the model's weights are drawn from the
config's seed on the CPU, then moved.  The other runners take a model and
arrays (the JAX versions take a config and restore a checkpoint; here
``entry.certify_model(checkpoint=...)`` builds the model).

``run_sample_grid`` enumerates the decision-boundary grid and may save it;
``run_certify`` sweeps it with the ``Certifier`` for the CROWN or the
Lipschitz certificate, in one call or streamed in image batches with the
JAX package's audit log, and may then branch-and-bound refine the clean but
uncertified images (``verify/refine.py``, ``verify/refine_lips.py``).

``run_autoattack`` runs the AutoAttack suite over the arrays in batches and
returns the fields of the JAX package's artifact
(``run_data/certified_full/autoattack_*.json``).

Every forward the attacks make goes through ``BudgetedForward``, which
records the largest number of solver steps attempted and raises if any
solve used its whole ``max_steps`` budget: a truncated solve would make the
reported robust accuracy unsound.  A completion probe (the first batch, and
the eps-ball corner of each image) runs first, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from .attacks.autoattack import STANDARD, AutoAttackSuite
from .models.backbones import make_backbone
from .models.dynamics import SimplexDynamics
from .models.ivp import OUTPUTS, NeuralODEClassifier
from .train.data import load_dataset
from .train.schedulers import (
    CompositeSamplerScheduler,
    ConstantScheduler,
    LinearScheduler,
    SwitchScheduler,
)
from .train.trainer import LyapunovTrainer, TrainConfig, frozen
from .verify.certify import Certifier, CertifyResult
from .verify.grid import enumerate_decision_boundary

__all__ = ["BudgetedForward", "build_model", "build_trainer", "run_train",
           "run_autoattack", "run_certify", "run_sample_grid"]


def _ordered_callbacks(cfg: dict, key: str):
    d = cfg.get(key, {}) or {}
    return [d[k] for k in sorted(d)]


def build_model(cfg: dict, device="cuda") -> NeuralODEClassifier:
    """The classifier a composed config describes, weights drawn from its
    seed on the CPU and moved to ``device``.  As in the JAX package: the
    init_fun's target UniformInitFun starts at the simplex centre and any
    other at zeros; an output target other than default, first_n or linear
    is the default output; ``val_ode_solver`` is the solve's method (a
    fixed-grid one needs ``step_size`` at the call, the config gives
    none)."""
    m, ds = cfg["module"], cfg["dataset"]
    dyn_cfg = m["dynamics"]
    pm = (m.get("init_fun") or {}).get("param_map") or {}
    init_target = (m.get("init_fun") or {}).get("target", "UniformInitFun")
    out_target = (m.get("output") or {}).get("target", "default")
    g = torch.Generator().manual_seed(int(cfg.get("seed", 0)))
    backbone = make_backbone(
        pm.get("target", "TinyMLP"), out_dim=int(pm.get("out_dim", 128)),
        act=pm.get("act", "GroupSort"), mu=tuple(ds["MU"]),
        std=tuple(ds["STD"]), in_channels=int(ds["IN_CHANNEL"]),
        img_size=int(ds["IMG_SIZE"][0]), generator=g)
    dynamics = SimplexDynamics(
        n_hidden=int(dyn_cfg.get("n_hidden", ds["N_CLASSES"])),
        mlp_size=int(dyn_cfg["mlp_size"]), x_dim=int(dyn_cfg["x_dim"]),
        activation=dyn_cfg["activation"], dropout=float(dyn_cfg["dropout"]),
        alpha_1=float(dyn_cfg["alpha_1"]), alpha_2=float(dyn_cfg["alpha_2"]),
        sigma_1=float(dyn_cfg["sigma_1"]),
        scale_nominal=bool(dyn_cfg["scale_nominal"]),
        cayley=bool(dyn_cfg["cayley"]), kappa=float(dyn_cfg["kappa"]),
        kappa_length=int(dyn_cfg["kappa_length"]), generator=g)
    model = NeuralODEClassifier(
        backbone=backbone, dynamics=dynamics, t_max=float(m["t_max"]),
        rtol=float(m.get("val_ode_tol", 1e-3)),
        atol=float(m.get("val_ode_tol", 1e-3)),
        max_steps=int(m.get("max_steps", 64)),
        n_classes=int(ds["N_CLASSES"]),
        h0_init="uniform" if init_target == "UniformInitFun" else "zeros",
        output=out_target if out_target in OUTPUTS else "default",
        method=m.get("val_ode_solver", "dopri5"), generator=g)
    return model.to(device)


def _build_scheduler(cfg: dict) -> Optional[CompositeSamplerScheduler]:
    nodes = _ordered_callbacks(cfg, "_sch_callback_dict")
    if not nodes:
        return None
    kinds = {
        "LinearScheduler": lambda n: LinearScheduler(
            rate=float(n.get("rate", 1.0)), bias=float(n.get("bias", 0.0)),
            clamp=n.get("clamp", "min"),
            clamp_val=float(n.get("clamp_val", 0.0)),
            start=int(n.get("start", 0))),
        "ConstantScheduler": lambda n: ConstantScheduler(
            float(n.get("constant", 1.0))),
        "SwitchScheduler": lambda n: SwitchScheduler(
            float(n.get("start", 0.0)), float(n.get("end", 1.0)),
            float(n.get("trigger", 1.0))),
    }
    schedulers = [kinds[n["target"]](n) for n in nodes]
    weights = (cfg["module"].get("sampler_scheduler") or {}).get(
        "scheduler_weights", [1.0] * len(schedulers))
    return CompositeSamplerScheduler(schedulers, [float(w) for w in weights])


def _load_cfg_dataset(cfg: dict):
    return load_dataset(
        cfg["dataset"]["name"], cfg.get("data_root", "data"),
        seed=int(cfg.get("seed", 0)),
        synthetic_size=int(cfg.get("synthetic_size", 4096)),
        synthetic_hardness=float(cfg.get("synthetic_hardness", 0.0)))


def build_trainer(cfg: dict, run_dir: Optional[str] = None,
                  device="cuda") -> LyapunovTrainer:
    """The trainer of a composed config (``run_data/<dataset>-<time>`` by
    default)."""
    m = cfg["module"]
    ds = _load_cfg_dataset(cfg)
    model = build_model(cfg, device)
    sampler_names = tuple(
        n["target"] for n in _ordered_callbacks(cfg, "_sampler_callback_dict")
    ) or ("UniformSimplexSampling", "CorrectConeSampling")
    lya = m.get("lya_cand") or {"target": "DecisionBoundary"}
    tcfg = TrainConfig(
        opt_name=m["opt_name"], lr=float(m["lr"]),
        momentum=float(m.get("momentum", 0.9)),
        weight_decay=float(m.get("weight_decay", 0.0)),
        beta1=float(m.get("beta1", 0.9)), beta2=float(m.get("beta2", 0.999)),
        scheduler_name=m.get("scheduler_name", "cos_anneal"),
        decay_epochs=tuple(m.get("decay_epochs", (90, 120, 150))),
        max_epochs=int(m["max_epochs"]), warmup=int(m.get("warmup", -1)),
        fix_backbone=bool(m.get("fix_backbone", False)),
        batch_size=int(cfg.get("batch_size", 128)),
        val_batch_size=int(cfg.get("val_batch_size", 256)),
        h_sample_size=int(m.get("h_sample_size", 128)),
        h_dist_lim=float(m.get("h_dist_lim", 15.0)),
        act=m.get("act", "relu"), lya_cand=lya["target"],
        lya_log_mode=bool(lya.get("log_mode", False)),
        sampler_names=sampler_names,
        barrier_loss=bool(m.get("barrier_loss", False)),
        relax_exp_stable=bool(m.get("relax_exp_stable", False)),
        scale_l_eps=float(m.get("scaleLeps", 3.0)),
        lips_train=bool(m.get("lips_train", False)),
        lips_warmup=int(m.get("lips_warmup", 0)),
        epoch_off_scale=int(m.get("epoch_off_scale", 10)),
        train_ode=bool(m.get("train_ode", False)),
        train_ode_epoch=int(m.get("train_ode_epoch", 100)),
        objective=m.get("objective", {
            "ODELearning": "ode", "ClassicalLearning": "classical",
        }.get(m.get("target"), "lyapunov")),
        adv_train=bool(m.get("adv_train", False)),
        val_adv=bool(m.get("val_adv", False)),
        eps=float(m.get("eps", 36 / 255)), norm=m.get("norm", "L2"),
        seed=int(cfg.get("seed", 0)),
    )
    if run_dir is None:
        stamp = time.strftime("%Y%m%d-%H%M%S")
        run_dir = str(Path(cfg.get("savedir", "run_data"))
                      / f"{cfg['dataset']['name']}-{stamp}")
    return LyapunovTrainer(model, tcfg, ds, scheduler=_build_scheduler(cfg),
                           run_dir=run_dir, device=device)


def run_train(cfg: dict, run_dir: Optional[str] = None, epochs=None,
              test_adv: bool = False, resume: bool = False, device="cuda"):
    """Train, then evaluate on the test split (and AutoAttack it with
    ``test_adv``); returns (trainer, test metrics).  The trained model is
    ``trainer.model``; its best checkpoint ``trainer.ckpt.path("best")``."""
    tr = build_trainer(cfg, run_dir, device)
    tr.fit(epochs=epochs, resume=resume)
    test = tr.evaluate(split="test",
                       generator=torch.Generator(tr.device).manual_seed(1))
    if test_adv:
        test.update(tr.test_autoattack(
            generator=torch.Generator(tr.device).manual_seed(2)))
    tr.writer.log({f"test_{k}": v for k, v in test.items()}, step=-1)
    tr.writer.console(f"test: {test}")
    return tr, test


def run_sample_grid(n: int = 10, T: int = 40,
                    out_path: Optional[str] = None) -> np.ndarray:
    """Enumerate the decision-boundary grid for n classes at resolution T,
    float32 (cells, n); saved with ``numpy.save`` to ``out_path`` if given
    (``run_certify`` takes the array back as ``grid``)."""
    t0 = time.time()
    grid = enumerate_decision_boundary(n, T)
    print(f"grid n={n} T={T}: {grid.shape[0]:,} cells in "
          f"{time.time() - t0:.1f}s")
    if out_path:
        np.save(out_path, grid)
    return grid


def run_certify(model: NeuralODEClassifier, xs, ys, method: str = "crown", *,
                T: int = 40, eps: float = 36 / 255, chunk: int = 8192,
                grid: Optional[np.ndarray] = None,
                scale_nominal: Optional[bool] = None,
                start_ind: int = 0, max_images: Optional[int] = None,
                image_batch: Optional[int] = None,
                stream_out: Optional[str] = None,
                refine_rounds: int = 0, refine_frontier_cap: int = 1 << 20,
                refine_box_budget: int = 64_000_000,
                refine_collect_cap: int = 4_000_000,
                refine_alpha_iters: int = 0,
                **certifier_kw) -> CertifyResult:
    """Certify the test images ``xs`` (N, C, H, W) in [0, 1] with labels
    ``ys`` from index ``start_ind`` on (at most ``max_images`` of them) on
    the device the model lies on; ``method`` is "crown" or "lipschitz".

    ``scale_nominal`` defaults to the dynamics' own flag.  With
    ``image_batch`` (or ``stream_out``, which implies batches of 10) the
    sweep is streamed: cumulative accuracies are printed after every batch
    and ``stream_out`` gets one JSON line per batch and a ``.json`` summary.
    Further keywords go to the ``Certifier`` (``alpha_iters``,
    ``alpha_objective``, ``with_upper``, ``std_min``).

    ``refine_rounds`` > 0 then branch-and-bound refines the clean but
    uncertified images (at most that many rounds; ``refine_frontier_cap``,
    ``refine_box_budget``, ``refine_collect_cap`` bound the work,
    ``refine_alpha_iters`` > 0 bounds the CROWN boxes with alpha-CROWN) and
    folds the recovered images into ``certified``; with ``stream_out`` it
    writes ``<stream_out>.refine.json`` (absolute image indices and the
    final ``certified_idx``), as the JAX package does.
    """
    end = len(xs) if max_images is None else min(len(xs), start_ind + max_images)
    xs, ys = xs[start_ind:end], ys[start_ind:end]
    if scale_nominal is None:
        scale_nominal = model.dynamics.scale_nominal
    cert = Certifier(model, T=T, eps_input=eps, chunk=chunk, grid=grid,
                     scale_nominal=scale_nominal, **certifier_kw)
    if stream_out and not image_batch:
        # a requested audit log implies the streamed sweep
        image_batch = 10
    if image_batch:
        res = cert.certify_stream(xs, ys, method=method,
                                  image_batch=image_batch,
                                  out_path=stream_out, start_ind=start_ind)
    else:
        res = cert.certify(xs, ys, method=method, progress_every=10)
    if refine_rounds > 0:
        _refine(cert, xs, ys, res, method, start_ind, stream_out,
                refine_rounds, refine_frontier_cap, refine_box_budget,
                refine_collect_cap, refine_alpha_iters)
    print(f"[{method}] range {start_ind}:{end} clean={res.clean_acc:.4f} "
          f"certified={res.certified_acc:.4f} "
          f"({res.cells_per_sec:,.0f} cells/sec)")
    return res


def _refine(cert, xs, ys, res, method, start, stream_out, rounds,
            frontier_cap, box_budget, collect_cap, alpha_iters):
    """``run_certify``'s refinement of ``res`` in place."""
    from .verify.refine import refine_uncertified
    from .verify.refine_lips import refine_lips_uncertified
    rkw = dict(clean=res.clean, chunk=cert.chunk, max_rounds=rounds,
               frontier_cap=frontier_cap, box_budget=box_budget,
               collect_cap=collect_cap, progress_every=1)
    if method == "crown":
        new_cert, rstats = refine_uncertified(
            cert, xs, ys, res.certified, alpha_iters=alpha_iters, **rkw)
    else:
        new_cert, rstats = refine_lips_uncertified(
            cert, xs, ys, res.certified, exact_ok=res.larger_T_certified,
            **rkw)
    rec = int(new_cert.sum() - res.certified.sum())
    print(f"[refine] recovered {rec} of "
          f"{int((res.clean & ~res.certified).sum())} uncertified "
          f"(rounds<={rounds})")
    res.certified = new_cert
    if stream_out:
        # the stats' image indices are slice-relative: the audit file takes
        # absolute test indices, as certified_idx does
        abs_stats = []
        for s in rstats:
            d = dataclasses.asdict(s)
            d["image"] += start
            abs_stats.append(d)
        with open(stream_out + ".refine.json", "w") as fh:
            json.dump({
                "refine_rounds": rounds,
                "start_ind": start,
                "recovered": rec,
                "certified_idx": sorted(
                    (start + np.nonzero(new_cert)[0]).tolist()),
                "stats": abs_stats,
            }, fh, indent=1)


class BudgetedForward:
    """``model.predict`` that tracks the solver's attempted steps.

    ``max_attempts`` is the largest ``n_accepted + n_rejected`` of any solve
    so far, ``forwards`` the number of solves.  A solve that reaches the
    model's ``max_steps`` raises ``RuntimeError``.
    """

    def __init__(self, model: NeuralODEClassifier):
        self.model = model
        self.max_attempts = 0
        self.forwards = 0

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        sol = self.model.solve(x)
        self.forwards += 1
        self.max_attempts = max(self.max_attempts, sol.attempts)
        if sol.attempts >= self.model.max_steps:
            raise RuntimeError(
                f"solver hit the max_steps={self.model.max_steps} step "
                f"budget (attempts={sol.attempts}) in an attack forward: "
                "raise max_steps; attacking a truncated solve would be unsound"
            )
        return self.model.output_fn(sol.ys[-1])


def run_autoattack(model: NeuralODEClassifier, xs: torch.Tensor,
                   ys: torch.Tensor, *, eps: float = 36 / 255,
                   norm: str = "L2", attacks: Sequence[str] = STANDARD,
                   n_iter: int = 100, square_queries: int = 5000,
                   batch_size: int = 512, seed: int = 0,
                   out_path: Optional[str] = None):
    """Attack ``xs`` (N, C, H, W) in [0, 1] with labels ``ys`` (N,).

    Runs in eval mode with the model's parameters frozen (restored after),
    on the device ``xs`` lies on; random starts draw from one generator on
    that device seeded with ``seed``.  Returns ``(summary, x_adv)``:
    ``summary`` holds the artifact's fields plus ``max_attempts``,
    ``forwards`` and per-attack ``attack_seconds``; ``x_adv`` (N, C, H, W)
    holds each broken image's validated adversarial and the input
    elsewhere.  Writes ``summary`` as JSON to ``out_path`` if given.
    """
    forward = BudgetedForward(model)
    suite = AutoAttackSuite(forward, eps=eps, norm=norm,
                            attacks_to_run=attacks, n_iter=n_iter,
                            square_queries=square_queries)
    generator = torch.Generator(device=xs.device).manual_seed(seed)
    was_training = model.training
    model.eval()
    try:
        with frozen(model):
            # completion probe: clean images and an eps-ball corner of each
            probe = xs[:min(64, len(xs))]
            with torch.no_grad():
                forward(torch.cat([
                    probe,
                    torch.clamp(probe + eps * torch.sign(probe - 0.5), 0.0, 1.0),
                ]))
            probe_attempts = forward.max_attempts
            robust_idx, x_adv = [], []
            t0 = time.perf_counter()
            for i in range(0, len(xs), batch_size):
                bx, by = xs[i:i + batch_size], ys[i:i + batch_size]
                xa, robust = suite.run(bx, by, generator)
                robust_idx += (i + torch.nonzero(robust)[:, 0]).tolist()
                x_adv.append(xa)
            elapsed = time.perf_counter() - t0
    finally:
        model.train(was_training)
    n = len(xs)
    summary = {
        "attacks": list(attacks),
        "n_iter": n_iter,
        "square_queries": square_queries,
        "eps": eps,
        "norm": norm,
        "t_max": model.t_max,
        "max_steps": model.max_steps,
        "probe_attempts": probe_attempts,
        "max_attempts": forward.max_attempts,
        "forwards": forward.forwards,
        "n_images": n,
        "robust_acc": len(robust_idx) / max(n, 1),
        "robust_idx": robust_idx,
        "seconds": elapsed,
        "images_per_sec": n / max(elapsed, 1e-9),
        "attack_seconds": dict(suite.seconds),
    }
    if out_path:
        with open(out_path, "w") as fh:
            json.dump(summary, fh, indent=2)
    return summary, torch.cat(x_adv)
