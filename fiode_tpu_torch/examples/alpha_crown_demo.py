"""alpha-CROWN on the images plain CROWN fails, on the card (counterpart of
examples/alpha_crown_demo.py).

    python -m fiode_tpu_torch.examples.alpha_crown_demo \\
        --run-dir run_data/certified_full --start 11 --end 12 --alpha-iters 2

It restores the run directory's checkpoint, sweeps the test images
[--start, --end) with plain CROWN, then certifies the clean but
uncertified ones again with ``--alpha-iters`` slope-optimisation steps
(``Certifier(alpha_iters=)``, ``verify/crown.optimize_crown_alphas``).

The flags are the JAX driver's, plus positional ``++key=value``
overrides of its config (``cifar_train.yaml``; the model and dataset only:
no trainer, whose writer would append to the run directory).
``--run-dir`` is only read; ``ALPHA_CROWN.json`` goes under ``--out-dir``
(default ``run_data/torch/alpha_crown_demo``).  ``--device`` defaults to
cuda.  The certificate is plain PyTorch; the clean check runs K3 and K1.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from ._common import (CONFIG_DIRS, add_run_options, compose, device_of,
                      out_dir)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--run-dir", default="run_data/certified_full")
    ap.add_argument("--start", type=int, default=20)
    ap.add_argument("--end", type=int, default=100)
    ap.add_argument("--T", type=int, default=40)
    ap.add_argument("--alpha-iters", type=int, default=3)
    ap.add_argument("--alpha-objective", default="vdot",
                    choices=["vdot", "width"],
                    help="'width' optimises the slopes against the pre-QP "
                    "bound width (a cheaper gradient)")
    ap.add_argument("overrides", nargs="*",
                    help="++key=value config overrides")
    add_run_options(ap, "alpha_crown_demo")
    return ap


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    device = device_of(args.device)
    out = out_dir(args)

    from ..experiment import _load_cfg_dataset, restore_model
    from ..verify.certify import Certifier
    from ..verify.grid import enumerate_decision_boundary

    cfg = compose("cifar_train.yaml",
                  ["++module.init_fun.param_map.out_dim=10", *args.overrides],
                  str(CONFIG_DIRS["train"]))
    model = restore_model(cfg, args.run_dir, device)
    ds = _load_cfg_dataset(cfg)
    xs, ys = ds.test_x[args.start:args.end], ds.test_y[args.start:args.end]
    grid = enumerate_decision_boundary(model.dynamics.n_hidden, args.T)

    # the JAX driver's chunk, or the whole grid where it is smaller (a chunk
    # is padded to its size); the restored checkpoint trained with
    # scale_nominal off from epoch 10, which the default scale_nominal=False
    # certifies
    chunk = min(4096, len(grid))
    plain = Certifier(model, T=args.T, eps_input=36 / 255, chunk=chunk, grid=grid)
    t0 = time.time()
    res_p = plain.certify(xs, ys, method="crown", early_exit=False,
                          progress_every=100)
    t_plain = time.time() - t0
    fail = np.nonzero(res_p.clean & ~res_p.certified)[0]
    print(f"[alpha-demo] plain CROWN: {res_p.certified.sum()}/{len(xs)} "
          f"certified ({res_p.cells_per_sec:,.0f} cells/s); {len(fail)} "
          "clean-but-uncertified", flush=True)

    result = {
        "index_range": [args.start, args.end],
        "plain_certified": int(res_p.certified.sum()),
        "n_images": len(xs),
        "plain_seconds": t_plain,
        "plain_cells_per_sec": res_p.cells_per_sec,
        "failing_idx": (fail + args.start).tolist(),
        "alpha_iters": args.alpha_iters,
        "alpha_objective": args.alpha_objective,
    }
    if len(fail):
        alpha = Certifier(model, T=args.T, eps_input=36 / 255, chunk=chunk, grid=grid,
                          alpha_iters=args.alpha_iters,
                          alpha_objective=args.alpha_objective)
        t0 = time.time()
        res_a = alpha.certify(xs[fail], ys[fail], method="crown",
                              early_exit=False, progress_every=100)
        result["alpha_seconds"] = time.time() - t0
        result["alpha_recovered"] = int(res_a.certified.sum())
        result["alpha_cells_per_sec"] = res_a.cells_per_sec
        result["combined_certified"] = int(res_p.certified.sum()
                                           + res_a.certified.sum())
        print(f"[alpha-demo] alpha-CROWN recovers {res_a.certified.sum()}/"
              f"{len(fail)} failed images -> {result['combined_certified']}/"
              f"{len(xs)} certified total ({res_a.cells_per_sec:,.0f} cells/s)",
              flush=True)

    (out / "ALPHA_CROWN.json").write_text(json.dumps(result, indent=2))
    print(json.dumps(result, indent=2), flush=True)
    return result


if __name__ == "__main__":
    main()
