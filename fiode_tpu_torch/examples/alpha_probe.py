"""Probe of alpha-CROWN's per-cell efficacy, on the card (counterpart of
examples/alpha_probe.py).

    python -m fiode_tpu_torch.examples.alpha_probe \\
        --run-dir run_data/certified_full --images 15 --sample 4096

For each image it sweeps the whole grid with plain CROWN, counts the
violated cells, then bounds a random sample of them again under
alpha-CROWN at several iteration counts, and records the fraction closed
and the shift of the value quantiles (p50, p90, p99).  The JAX driver's
measurement (``run_data/certified_full/alpha_probe.json``) closed at most
0.25% of the violated cells: the slack there lies in the QP and sigmoid
interval steps, not in the ReLU relaxation.

The JAX driver has no flags.  Two of its constants are flags here with
its values as defaults (``--images``, ``--sample``); the others stay
constants (``ITERS``, the block sizes, the config and the output name).
Like every driver it takes ``--run-dir``, positional ``++key=value``
overrides, ``--device`` (default cuda) and ``--out-dir`` (default
``run_data/torch/alpha_probe``).  The sweep and the boxes go through
``verify/refine``'s evaluators (``_kernels(cert, alpha_iters=)``) on its
row blocks; the JAX driver's padding of every call to a static shape is
left behind.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ._common import (add_run_options, certifier, certify_setup, device_of,
                      out_dir)


ITERS = [2, 4, 8]  # alpha-CROWN iteration counts
CHUNK, SUPERCHUNK = 8192, 16
CONFIG_NAME, OUT = "cifar_certify.yaml", "alpha_probe.json"


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--run-dir", default="run_data/certified_full")
    ap.add_argument("--images", default="11,24,37,47,115",
                    help="test indices (collect_cap x2, frontier_cap x2, "
                    "box blow-up in the JAX refinement passes)")
    ap.add_argument("--sample", type=int, default=65536,
                    help="violated cells bounded again per image")
    ap.add_argument("overrides", nargs="*",
                    help="++key=value config overrides (e.g. ++T=6)")
    add_run_options(ap, "alpha_probe")
    return ap


def _quantiles(vals: np.ndarray) -> list:
    return [round(float(q), 4) for q in np.percentile(vals, [50, 90, 99])]


def main(argv=None) -> list:
    args = _parser().parse_args(argv)
    device = device_of(args.device)
    out = out_dir(args)

    from ..verify import refine as R
    from ..verify.certify import float32_matmuls

    cfg, model, ds = certify_setup(args, device, CONFIG_NAME)
    cert = certifier(cfg, model)
    images = [int(s) for s in args.images.split(",") if s.strip()]
    sweep_fn, _ = R._kernels(cert, alpha_iters=0)
    alpha_steps = {k: R._kernels(cert, alpha_iters=k)[1] for k in ITERS}
    rng = np.random.default_rng(0)
    records = []
    with torch.no_grad(), float32_matmuls():
        x = torch.from_numpy(ds.test_x[images]).to(device)
        image = R._images(cert, x, np.arange(len(images)))
        for k, img_idx in enumerate(images):
            img = image(k, ds.test_y[img_idx])
            t0 = time.time()
            viol, vals = [], []
            for cells in R._label_blocks(cert, img.label, CHUNK, SUPERCHUNK):
                v = sweep_fn(cells, img)
                bad = ~(v <= 0.0)  # NaN counts as violated
                viol.append(cells[bad])
                vals.append(v[bad])
            centers, vvals = torch.cat(viol), torch.cat(vals).cpu().numpy()
            rec = {"image": int(img_idx), "plain_violated": len(centers),
                   "sweep_s": round(time.time() - t0, 1),
                   "plain_val_q": _quantiles(vvals) if len(vvals) else []}
            if len(centers):
                sel = rng.choice(len(centers), min(args.sample, len(centers)),
                                 replace=False)
                sample = centers[torch.from_numpy(sel).to(device)]
                half = torch.full_like(sample, cert.eps)
                for it in ITERS:
                    t0 = time.time()
                    avals, _ = R._evaluate(alpha_steps[it], sample, half, img,
                                           CHUNK * SUPERCHUNK)
                    avals = avals.cpu().numpy()
                    dt = time.time() - t0
                    rec[f"alpha{it}_closed_frac"] = round(
                        float((avals <= 0.0).mean()), 4)
                    rec[f"alpha{it}_cells_per_s"] = round(len(sample) / dt, 1)
                    rec[f"alpha{it}_val_q"] = _quantiles(avals)
            records.append(rec)
            print(json.dumps(rec), flush=True)
    (out / OUT).write_text(json.dumps(records, indent=1))
    print("done", flush=True)
    return records


if __name__ == "__main__":
    main()
