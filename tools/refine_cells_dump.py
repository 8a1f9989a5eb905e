#!/usr/bin/env python3
"""Dump, on a CUDA card, the grid cells that decide the violated counts of
``chip_smoke.py``'s phase 14, for ``tools/refine_float32_reference.py`` to
evaluate through the JAX package in float32 on the CPU.

    python3 tools/refine_cells_dump.py [--out build/refine_cells.npz]

Trained checkpoint (``best_torch.npz``), synthetic test set, T = 40, input
eps 0.141, the whole 41,320,837-cell grid.  Per image, in label space:

  * CROWN (images 15, 95, 221) and the hybrid bound (image 15): every cell
    whose value is above -NEAR, with its value;
  * Lipschitz (images 3, 7): the count of violated cells (value not < 0)
    and every cell whose value lies within BAND of 0, with its value.

Imports torch and the port only.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
CROWN_IMAGES, HYBRID_IMAGES, LIPS_IMAGES = (15, 95, 221), (15,), (3, 7)
NEAR, BAND = 0.02, 2e-4


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "build" / "refine_cells.npz"))
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    from fiode_tpu_torch.entry import certify_model
    from fiode_tpu_torch.train.data import load_dataset
    from fiode_tpu_torch.verify import refine, refine_lips
    from fiode_tpu_torch.verify.certify import Certifier, float32_matmuls

    model = certify_model(checkpoint=ROOT / "run_data" / "certified_full" / "ckpt"
                          / "best_torch.npz", device="cuda")
    ds = load_dataset("CIFAR10", str(ROOT / "data"))
    cert = Certifier(model, T=40, eps_input=0.141, chunk=8192)
    out = {}
    with torch.no_grad(), float32_matmuls():
        runs = [("crown", i, refine._kernels(cert)[0]) for i in CROWN_IMAGES]
        runs += [("hybrid", i, refine._kernels(cert, lips_box=True)[0])
                 for i in HYBRID_IMAGES]
        runs += [("lips", i, refine_lips._lips_kernels(cert)[0]) for i in LIPS_IMAGES]
        for kind, i, sweep_fn in runs:
            x = torch.from_numpy(ds.test_x[i:i + 1]).cuda()
            img = refine._images(cert, x, [0])(0, int(ds.test_y[i]))
            t0 = time.perf_counter()
            cells, vals, n_viol = [], [], 0
            for block, nb in refine._label_blocks(cert, img.label, 8192, 16):
                v = sweep_fn(block, img)[:nb]
                if kind == "lips":
                    n_viol += int((~(v < 0.0)).sum())
                    keep = v.abs() < BAND
                else:
                    n_viol += int((~(v <= 0.0)).sum())
                    keep = v > -NEAR
                cells.append(block[:nb][keep])
                vals.append(v[keep])
            tag = f"{kind}_{i}"
            out[f"cells_{tag}"] = torch.cat(cells).cpu().numpy()
            out[f"vals_{tag}"] = torch.cat(vals).cpu().numpy()
            out[f"violated_{tag}"] = np.int64(n_viol)
            out[f"feats_{i}"] = model.features(x).cpu().numpy()[0]
            print(f"{kind} image {i}: {n_viol} violated, {len(out[f'vals_{tag}'])} "
                  f"cells kept, {time.perf_counter() - t0:.1f} s", flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    np.savez(args.out, **out)
    print(f"wrote {args.out}", flush=True)


if __name__ == "__main__":
    main()
