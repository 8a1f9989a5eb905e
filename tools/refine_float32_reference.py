#!/usr/bin/env python3
"""The JAX package's float32 answers, on the CPU, for the cells that
``tools/refine_cells_dump.py`` dumped on the card: the reference of
``chip_smoke.py``'s phase 14.

    JAX_PLATFORMS=cpu python tools/refine_float32_reference.py \
        [--dump build/refine_cells.npz]

The committed refinement artifacts (``refine_full_pass*_stream.jsonl``,
``hybrid_sweep_stream.jsonl``, ``refine_lips_probe.json``) were computed on
a TPU whose backbone features were not float32-exact, so their violated
counts are not those of a float32 evaluation.  This script restores the
trained checkpoint through the JAX package, computes each image's features
on the CPU in float32, and evaluates the JAX package's own sweep functions
(``verify/refine._kernels``, ``verify/refine_lips._lips_kernels``) on the
dumped cells:

  * CROWN and hybrid: the dump holds every cell within 0.02 of violating
    on the card, so the cells the JAX package finds violated among them
    are its violated set (a cell outside it would need the two to differ
    by more than 0.02; they differ by at most ~2e-3).  Its ``_bab`` then
    runs on those cells at phase 14's budgets: rounds, boxes, verdict.
  * Lipschitz: the dump holds the violated count on the card and every
    cell within 2e-4 of 0; the JAX count is the card's with that band
    re-decided by the JAX package.

Prints one JSON object: image -> base_violated, rounds, boxes_evaluated,
certified, gave_up, worst (of the dumped cells).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dump", default=str(ROOT / "build" / "refine_cells.npz"))
    args = ap.parse_args()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(ROOT))
    import jax.numpy as jnp

    from fiode_tpu.experiment import _restore_params, build_model
    from fiode_tpu.train.data import load_dataset
    from fiode_tpu.utils.config import compose
    from fiode_tpu.verify import refine, refine_lips
    from fiode_tpu.verify.certify import Certifier

    d = np.load(args.dump)
    cfg = compose("cifar_certify", [], str(ROOT / "configs" / "certify"))
    model = build_model(cfg)
    params = _restore_params(cfg, model, str(ROOT / "run_data" / "certified_full"))
    ds = load_dataset("CIFAR10", str(ROOT / "data"))
    # a one-cell grid: the cells come from the dump, not from an enumeration
    cert = Certifier(model, params, T=40, eps_input=0.141, scale_nominal=False,
                     grid=np.full((1, 10), 0.1, np.float32))
    bab_budgets = dict(chunk=8192, superchunk=16, max_rounds=60,
                       frontier_cap=1 << 26, box_budget=2_000_000_000,
                       device_factory=None)
    kernels = {"crown": refine._kernels(cert), "hybrid": refine._kernels(cert, lips_box=True),
               "lips": refine_lips._lips_kernels(cert)}
    out = {}
    for key in sorted(k for k in d.files if k.startswith("cells_")):
        kind, i = key[len("cells_"):].split("_")
        i = int(i)
        cells, card_vals = d[key], d[f"vals_{kind}_{i}"]
        feats = np.asarray(cert._features(params, jnp.asarray(ds.test_x[i:i + 1])))[0]
        label = int(ds.test_y[i])
        sweep_fn, step_fn = kernels[kind][0], kernels[kind][1]
        arg = feats if kind == "lips" else feats @ np.asarray(cert.U).T + np.asarray(cert.bU)
        C = 1024
        pad = np.zeros(((-len(cells)) % C, 10), np.float32)
        vals = np.asarray(sweep_fn(jnp.asarray(np.concatenate([cells, pad]).reshape(-1, C, 10)),
                                   jnp.asarray(arg), label)).reshape(-1)[:len(cells)]
        rec = {"features_max_abs_diff": float(np.abs(feats - d[f"feats_{i}"]).max()),
               "cells": int(len(cells)),
               "values_max_abs_diff": float(np.abs(vals - card_vals).max()) if len(cells) else 0.0}
        if kind == "lips":
            card = int(d[f"violated_{kind}_{i}"])
            rec["base_violated"] = (card - int((~(card_vals < 0.0)).sum())
                                    + int((~(vals < 0.0)).sum()))
            rec["card_violated"] = card
        else:
            viol = cells[~(vals <= 0.0)]
            ok, rounds, boxes, gave = refine._bab(step_fn, jnp.asarray(arg), label, viol,
                                                  cert.eps, 10, **bab_budgets)
            rec.update(base_violated=int(len(viol)), rounds=rounds, boxes_evaluated=boxes,
                       certified=bool(ok), gave_up=gave, worst=float(vals.max()),
                       card_violated=int(d[f"violated_{kind}_{i}"]))
        out[f"{kind} {i}"] = rec
        print(f"{kind} image {i}: {rec}", file=sys.stderr, flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
