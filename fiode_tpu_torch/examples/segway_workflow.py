"""Segway safe-controller workflow on the card (counterpart of
examples/segway_workflow.py): LQR fit (300 iterations), then barrier
adversarial training (300 iterations, Linf PGD at eps 0.02), then the
CROWN + interval certificate over the r = 0.01 grid in the inflated
Lyapunov band, then the closed-loop trajectory check.

    python -m fiode_tpu_torch.examples.segway_workflow [--out-dir DIR]

Writes ``segway.npz`` (the controller, read by ``control.load_segway``;
the JAX driver's pickle is left behind) and ``SEGWAY_RESULTS.json`` with the
JAX driver's fields under ``--out-dir`` (alias ``--out``, the JAX flag;
default ``run_data/torch/segway_workflow``, off the committed
``run_data/segway/``).  ``--device`` defaults to cuda.  No TPU kernel is on
this path.
"""
from __future__ import annotations

import argparse
import json
import time

from ._common import add_run_options, device_of, out_dir


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--r", type=float, default=0.01)
    ap.add_argument("--margin", type=float, default=0.01)
    add_run_options(ap, "segway_workflow", "--out")
    return ap


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    device = device_of(args.device)
    out = out_dir(args)

    from ..control.certify_segway import certify_segway
    from ..control.train_segway import SegwayTrainConfig, train_segway

    t0 = time.time()
    cfg = SegwayTrainConfig(adv_train=True, fit_lqr_iters=args.iters,
                            barrier_iters=args.iters, margin=args.margin)
    model = train_segway(cfg, save_path=str(out / "segway.npz"), device=device)
    train_s = time.time() - t0

    t0 = time.time()
    res = certify_segway(str(out / "segway.npz"), r=args.r, plot_dir=str(out),
                         device=device)
    certify_s = time.time() - t0

    results = {
        "train_seconds": train_s,
        "best_barrier_loss": model["best_loss"],
        "certify_seconds": certify_s,
        "n_cells": res.n_cells,
        "vdot_ub_max": res.ub_max,
        "vdot_exact_max": res.exact_vdot_max,
        "certified": bool(res.certified),
        "level_band": [res.level_lb, res.level_ub],
        "traj_max_level_drift": res.traj_max_level_drift,
    }
    (out / "SEGWAY_RESULTS.json").write_text(json.dumps(results, indent=2))
    print(json.dumps(results, indent=2), flush=True)
    return results


if __name__ == "__main__":
    main()
