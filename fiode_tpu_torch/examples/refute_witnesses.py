"""Exact-witness audit of the images refinement left open, on the card
(counterpart of examples/refute_witnesses.py).

    python -m fiode_tpu_torch.examples.refute_witnesses \\
        --run-dir run_data/certified_full --images 11

For every image it sweeps the whole grid with the exact Vdot (the larger-T
certificate's quantity, ``Certifier.exact_witness``) and records the
maximising lattice point:

- ``refuted`` (witness value > 0): the lattice point is the centre of its
  cell's box, so every sound upper bound over any box holding it is >= the
  exact value > 0.  No sound box method certifies the image at this
  (T, eps, kappa) protocol;
- ``tractable`` (witness value < 0): ``-value`` is the bound slack
  refinement must close; margin / (sqrt(2) Lf_eta(eta_ub)) estimates the
  box half-width that needs.

The flags are the JAX driver's, plus positional ``++key=value``
overrides.  ``--run-dir`` is only read (its best parameters and, without
``--images``, the ``open_images`` of ``--accounting``); the JSON goes under
``--out-dir`` (default ``run_data/torch/refute_witnesses``).  ``--device``
defaults to cuda.  On the card every cell goes through K1.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np

from ._common import (add_run_options, certifier, certify_setup, device_of,
                      out_dir)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--run-dir", default="run_data/certified_full")
    ap.add_argument("--config-name", default="cifar_certify.yaml")
    ap.add_argument("--accounting", default="refine_accounting.json")
    ap.add_argument("--images", default=None,
                    help="comma-separated test indices (default: the "
                    "accounting's open_images)")
    ap.add_argument("--out", default="exact_witnesses.json")
    ap.add_argument("overrides", nargs="*",
                    help="++key=value config overrides (e.g. ++T=6)")
    add_run_options(ap, "refute_witnesses")
    return ap


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    device = device_of(args.device)
    out = out_dir(args)

    if args.images is not None:
        imgs = sorted({int(s) for s in args.images.split(",") if s.strip()})
    else:
        acct = json.loads((Path(args.run_dir) / args.accounting).read_text())
        imgs = sorted(acct["open_images"])
    if not imgs:
        raise SystemExit("no open images to audit")

    cfg, model, ds = certify_setup(args, device)
    cert = certifier(cfg, model)
    if cert.kappa_lips != cert.kappa:
        raise SystemExit("kappa_lips != kappa (scale_nominal certifier): the "
                         "witness quantity would not refute the CROWN "
                         "certificate; aborting")
    x, y = ds.test_x[imgs], ds.test_y[imgs]
    print(f"witness sweep over {len(imgs)} images, {len(cert.grid):,} cells "
          f"each (T={cert.T}, kappa={cert.kappa:.6f}, "
          f"precision={cert.matmul_precision})", flush=True)
    t0 = time.time()
    vals, idxs, clean = cert.exact_witness(x, y)
    dt = time.time() - t0

    # the local Lipschitz constant of Vdot in eta at the witness: a box
    # around a margin-m point needs a half-width ~ m / (sqrt(2) Lf_eta)
    records = []
    for k, img in enumerate(imgs):
        label = int(y[k])
        perm = np.arange(cert.n)
        perm[0], perm[label] = label, 0
        cell = cert.grid[int(idxs[k])][perm]
        eta_ub = float(cell.max()) + cert.eps
        lf_eta = (np.sqrt(cert.n) * cert.sigma_1 * cert.alpha_1
                  * np.exp(cert.sigma_1 * eta_ub) + 1.0)
        margin = -float(vals[k])
        records.append({
            "image": int(img),
            "label": label,
            "clean": bool(clean[k]),
            "witness_value": float(vals[k]),
            "verdict": "refuted" if vals[k] > 0 else "tractable",
            "witness_cell_idx": int(idxs[k]),
            "witness_cell_label_space": [float(v) for v in cell],
            "exact_margin": margin,
            "required_half_width_est":
                margin / float(np.sqrt(2.0) * lf_eta) if margin > 0 else 0.0,
        })
    refuted = [r["image"] for r in records if r["verdict"] == "refuted"]
    tractable = [r["image"] for r in records if r["verdict"] == "tractable"]
    result = {
        "n_images": len(imgs),
        "T": cert.T,
        "kappa": cert.kappa,
        "matmul_precision": cert.matmul_precision,
        "cells_per_image": len(cert.grid),
        "seconds": dt,
        "refuted": refuted,
        "tractable": tractable,
        "witnesses": records,
    }
    (out / args.out).write_text(json.dumps(result, indent=1) + "\n")
    print(f"refuted {len(refuted)}: {refuted}", flush=True)
    print(f"tractable {len(tractable)}: {tractable}", flush=True)
    for r in sorted(records, key=lambda r: r["witness_value"]):
        print(f"  img {r['image']:3d} {r['verdict']:9s} "
              f"witness {r['witness_value']:+.6f} "
              f"req_halfwidth~{r['required_half_width_est']:.2e}", flush=True)
    print(f"-> {out / args.out} ({dt:.0f}s)", flush=True)
    return result


if __name__ == "__main__":
    main()
