#!/usr/bin/env python3
"""Export the committed orbax checkpoint as a flat ``.npz`` that the PyTorch
port reads without JAX.

    JAX_PLATFORMS=cpu python tools/export_torch_checkpoint.py \
        [--run-dir run_data/certified_full] [--config cifar_certify] \
        [--out run_data/certified_full/ckpt/best_torch.npz]

Restores ``<run-dir>/ckpt/best`` through the JAX package (this converter is
the one place that imports both worlds; the port itself never does) and
writes the params tree with ``/``-joined flax names, e.g.
``backbone/CayleyConv_0/weight`` or ``dynamics/mlp_to_mlp/bias``: float32
numpy arrays only, no pickle.  ``fiode_tpu_torch.bridge.load_npz`` reads the
file back into a model; ``save_npz`` writes the same names.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]


def flatten(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from flatten(val, prefix + (key,))
        else:
            yield "/".join(prefix + (key,)), np.asarray(val)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--run-dir", default=str(REPO / "run_data" / "certified_full"))
    ap.add_argument("--config", default="cifar_certify")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))

    import jax

    from fiode_tpu.experiment import _restore_params, build_model
    from fiode_tpu.utils.config import compose

    cfg = compose(args.config, [], str(REPO / "configs" / "certify"))
    params = _restore_params(cfg, build_model(cfg), args.run_dir)
    flat = dict(flatten(jax.tree_util.tree_map(np.asarray, params)))
    out = Path(args.out or Path(args.run_dir) / "ckpt" / "best_torch.npz")
    np.savez(out, **flat)
    size = out.stat().st_size
    print(f"wrote {out}: {len(flat)} arrays, "
          f"{sum(a.size for a in flat.values()):,} values, {size:,} bytes")


if __name__ == "__main__":
    main()
