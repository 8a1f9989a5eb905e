#!/usr/bin/env python3
"""Train the Segway safe controller with the JAX package in float32 and
record its answers, the reference the PyTorch port is held to.

    JAX_PLATFORMS=cpu python tools/export_segway_reference.py \
        [--out run_data/segway/segway_f32] [--iters 300] [--margin 0.01]

Runs ``fiode_tpu.control.train_segway`` at examples/segway_workflow.py's
protocol (LQR fit, then barrier training with Linf PGD at eps 0.02, seed 0;
about 2.5 min on a CPU) and writes:

  * ``<out>.npz``: the trained controller in the port's layout, written by
    ``fiode_tpu_torch.control.save_segway`` (a flat ``.npz`` of float32
    arrays under flax names, nothing pickled; ``load_segway`` reads it);
  * ``<out>.json``: the JAX package's float32 answers on it: the best
    barrier loss; for r = 0.01 and r = 0.0025 the cells in the inflated
    level band, the band, the largest upper bound and exact value of Vdot
    and the verdict; and five closed-loop simulations to t = 50 from the
    starts ``certify_segway`` draws (PRNGKey(0)), with their endpoints.

r = 0.01 is certified by ``certify_segway`` itself.  Its grid at r = 0.0025
is 302 M states, which ``certify_segway`` builds as one float64 meshgrid
(~18 GB), so this script walks that grid in slabs of the outermost meshgrid
axis (v) with the package's own ``reject_sampling``, ``vdot_cell_bounds``
and ``LyaQuadratic``; it checks the walk against ``certify_segway`` at
r = 0.01 first.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import re
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
LEVEL = 0.15
RADII = (0.01, 0.0025)
CHUNK = 65536


def band_walk(model, r, region=1.5, phi_region=float(np.pi / 12)):
    """certify_segway's answers at ``r``, with the grid built one v slab at
    a time (the same cells in the same order)."""
    import jax
    import jax.numpy as jnp

    from fiode_tpu.control.certify_segway import vdot_cell_bounds
    from fiode_tpu.control.controllers import NNController, NNControllerModule
    from fiode_tpu.control.lyapunov_ctrl import LyaQuadratic
    from fiode_tpu.control.samplers import reject_sampling
    from fiode_tpu.control.systems import Segway

    system = Segway()
    P = jnp.asarray(model["P"])
    lya = LyaQuadratic(P, jnp.zeros((1, 3)))
    ctrl = NNController(NNControllerModule(hidden=int(model["config"]["hidden"])),
                        model["ctrl"])
    Ws, bs = ctrl.dense_weights()
    Ws = [jnp.asarray(W) for W in Ws]
    bs = [jnp.asarray(b) for b in bs]
    sigma = lya.sigma_max()
    level_ub = (np.sqrt(LEVEL) + np.sqrt(3) / 2 * r * sigma) ** 2
    level_lb = max((np.sqrt(LEVEL) - np.sqrt(3) / 2 * r * sigma) ** 2, 0.0)

    @jax.jit
    def chunk_max(cells):
        with jax.default_matmul_precision("float32"):
            _, ub = vdot_cell_bounds(system, Ws, bs, P, cells, r / 2)
            exact = lya.h_dot(cells, system(cells, ctrl(cells)))[:, 0]
        return jnp.max(ub), jnp.max(exact)

    # grid_uniform_3d: meshgrid(phi, v, phi_dot) in "xy" order, so v is the
    # outermost axis of the flattened grid
    d = [np.arange(-s, s, r) for s in (phi_region, region, region)]
    n_cells, ub_max, exact_max = 0, -np.inf, -np.inf
    kept = []
    for v in d[1]:
        a, c = np.meshgrid(d[0], d[2], indexing="ij")
        slab = np.stack([a.reshape(-1), np.full(a.size, v), c.reshape(-1)],
                        axis=1).astype(np.float32)
        kept.append(reject_sampling(slab, lya, level_lb, level_ub))
        if sum(len(k) for k in kept) >= CHUNK or v == d[1][-1]:
            cells = np.concatenate(kept)
            kept = []
            for i in range(0, len(cells), CHUNK):
                blk = cells[i:i + CHUNK]
                pad = CHUNK - len(blk)  # one compiled shape: pad with a kept cell
                blk = np.concatenate([blk, np.repeat(blk[:1], pad, 0)])
                u, e = chunk_max(jnp.asarray(blk))
                ub_max = max(ub_max, float(u))
                exact_max = max(exact_max, float(e))
            n_cells += len(cells)
    return {"n_cells": n_cells, "level_lb": float(level_lb),
            "level_ub": float(level_ub), "ub_max": ub_max,
            "exact_vdot_max": exact_max, "certified": bool(ub_max <= 0.0)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(REPO / "run_data" / "segway" / "segway_f32"))
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--margin", type=float, default=0.01)
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))

    import jax
    import jax.numpy as jnp

    from fiode_tpu.control.certify_segway import certify_segway
    from fiode_tpu.control.controllers import NNController, NNControllerModule
    from fiode_tpu.control.lyapunov_ctrl import LyaQuadratic
    from fiode_tpu.control.samplers import random_uniform, reject_sampling
    from fiode_tpu.control.systems import Segway
    from fiode_tpu.control.train_segway import SegwayTrainConfig, train_segway
    from fiode_tpu.ode.integrate import odeint
    from fiode_tpu_torch.bridge import segway_from_numpy
    from fiode_tpu_torch.control import save_segway

    cfg = SegwayTrainConfig(adv_train=True, fit_lqr_iters=args.iters,
                            barrier_iters=args.iters, margin=args.margin)
    t0 = time.perf_counter()
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        res = train_segway(cfg, verbose=True)
    train_s = time.perf_counter() - t0
    print(log.getvalue(), end="")
    first = re.search(r"iter 0: loss=([-0-9.e+]+)", log.getvalue())
    model = jax.tree_util.tree_map(np.asarray, {"ctrl": res["ctrl"], "P": res["P"]})
    model["config"] = res["config"]

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    ctrl, P = segway_from_numpy(model, "cpu")
    save_segway(out.with_suffix(".npz"), {
        "ctrl": ctrl, "P": P, "K_lqr": res["K_lqr"],
        "best_loss": res["best_loss"], "config": res["config"]})

    # r = 0.01 through certify_segway itself, and the slab walk held to it
    whole = certify_segway(model=model, r=RADII[0], simulate_trajectories=True,
                           verbose=True)
    cert = {}
    for r in RADII:
        t1 = time.perf_counter()
        cert[str(r)] = band_walk(model, r)
        cert[str(r)]["seconds"] = time.perf_counter() - t1
        print(f"[reference] r={r}: {cert[str(r)]}", flush=True)
    walk = cert[str(RADII[0])]
    for key in ("n_cells", "ub_max", "exact_vdot_max", "certified"):
        if walk[key] != getattr(whole, key):
            raise RuntimeError(f"the slab walk disagrees with certify_segway on "
                               f"{key}: {walk[key]} vs {getattr(whole, key)}")
    cert[str(RADII[0])]["traj_max_level_drift"] = whole.traj_max_level_drift

    # the five starts certify_segway simulates from, and their endpoints
    system = Segway()
    lya = LyaQuadratic(jnp.asarray(model["P"]), jnp.zeros((1, 3)))
    ctrl = NNController(NNControllerModule(hidden=cfg.hidden), model["ctrl"])
    x0 = random_uniform(jax.random.PRNGKey(0),
                        jnp.asarray([float(np.pi / 12), 1.5, 1.5]), 1000)
    x0 = reject_sampling(np.asarray(x0), lya, LEVEL - 0.02, LEVEL)[:5]
    ts = np.linspace(0.0, 50.0, 200)
    sol = odeint(lambda t, x, _: system(x, ctrl(x, t)), jnp.asarray(x0),
                 jnp.asarray(ts), method="dopri5", rtol=1e-6, atol=1e-6,
                 max_steps=100_000, mode="while")
    xs = np.asarray(sol.ys)
    levels = np.asarray(jax.vmap(lambda x: lya(x)[:, 0])(sol.ys))

    ref = {
        "what": "the JAX package's float32 answers on segway_f32.npz "
                "(tools/export_segway_reference.py)",
        "platform": jax.default_backend(), "jax": jax.__version__,
        "config": res["config"], "train_seconds": train_s,
        "first_barrier_loss": float(first.group(1)) if first else None,
        "best_loss": float(res["best_loss"]), "level": LEVEL,
        "certify": cert,
        "simulate": {"ts": [0.0, 50.0, len(ts)], "rtol": 1e-6, "atol": 1e-6,
                     "x0": x0.tolist(), "endpoint": xs[-1].tolist(),
                     "max_level_drift": float(levels.max() - LEVEL),
                     "nfe": int(sol.nfe), "n_accepted": int(sol.n_accepted),
                     "n_rejected": int(sol.n_rejected)},
    }
    out.with_suffix(".json").write_text(json.dumps(ref, indent=1) + "\n")
    print(json.dumps(ref, indent=1))


if __name__ == "__main__":
    main()
