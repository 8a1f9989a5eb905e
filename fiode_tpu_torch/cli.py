"""Command-line interface (counterpart of ``fiode_tpu/cli.py``): the nine
commands of the JAX package, on the card unless ``--device cpu``.

  python -m fiode_tpu_torch train          --config-name cifar_train.yaml [k=v ...]
  python -m fiode_tpu_torch sample-grid    --config-name cifar_certify.yaml ++T=40 [--out grid.npy]
  python -m fiode_tpu_torch certify-crown  --config-name cifar_certify.yaml --run-dir RUN [k=v ...]
  python -m fiode_tpu_torch certify-lipschitz --config-name cifar_certify.yaml --run-dir RUN
    (++mesh_shape=[n_img,n_cell] splits the sweep over a 2-D device mesh,
     an int the cells over a 1-D one; ++refine_rounds=N branch-and-bound
     refines the clean but uncertified images after the sweep, CROWN boxes
     by verify/refine.py (++refine_alpha_iters=K: alpha-CROWN), the
     Lipschitz grid-gap slack by verify/refine_lips.py; ++load_grid=True
     ++grid_name=PATH reads a sample-grid file)
  python -m fiode_tpu_torch eval-autoattack   --config-name cifar_certify.yaml --run-dir RUN
  python -m fiode_tpu_torch summarize-stream  RUN/certify_stream.jsonl [--out SUMMARY.json]
  python -m fiode_tpu_torch data-check     [--dataset CIFAR10] [--data-root data]
  python -m fiode_tpu_torch segway-train   [--save PATH.npz]
  python -m fiode_tpu_torch segway-certify [--model PATH.npz]

A run directory's parameters are read from RUN/ckpt/best.npz (written by
``train``), else RUN/ckpt/best_torch.npz (a JAX checkpoint exported by
tools/export_torch_checkpoint.py).  ``train --multihost`` joins the
process group of ``python -m torch.distributed.run --standalone
--nproc_per_node=N -m fiode_tpu_torch train --multihost ...``; process i > 0
writes under RUN/proc<i>/.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from .utils.config import compose

REPO = Path(__file__).resolve().parents[1]
CONFIG_DIRS = {
    "train": REPO / "configs" / "classification",
    "certify": REPO / "configs" / "certify",
}
RESTORE_HELP = ("run directory: parameters from RUN/ckpt/best.npz, else "
                "RUN/ckpt/best_torch.npz")


def _compose(args, kind):
    cfg_dir = args.config_dir or str(CONFIG_DIRS[kind])
    return compose(args.config_name, args.overrides, cfg_dir)


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="fiode_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def add(name, kind=None, help=None):
        sp = sub.add_parser(name, help=help)
        sp.add_argument("--device", default="cuda",
                        help="torch device to run on (default cuda)")
        if kind:
            sp.add_argument("--config-name", required=True)
            sp.add_argument("--config-dir", default=None,
                            help=f"default {CONFIG_DIRS[kind]}")
            sp.add_argument("overrides", nargs="*")
        return sp

    sp = add("train", "train", help="Lyapunov certified training")
    sp.add_argument("--run-dir", default=None)
    sp.add_argument("--epochs", type=int, default=None)
    sp.add_argument("--test-adv", action="store_true",
                    help="run AutoAttack apgd-ce/apgd-t at test time")
    sp.add_argument("--resume", action="store_true",
                    help="continue from the run dir's resume checkpoint")
    sp.add_argument("--multihost", action="store_true",
                    help="join the torch.distributed process group that "
                    "torch.distributed.run describes (MASTER_ADDR, "
                    "MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK; NCCL on "
                    "cuda:LOCAL_RANK, gloo on the CPU); process i > 0 "
                    "writes under RUN/proc<i>/")

    sp = add("sample-grid", "certify", help="enumerate the decision-boundary grid")
    sp.add_argument("--out", default=None,
                    help="write the grid here (numpy .npy format, exactly "
                    "this path)")

    for name in ("certify-crown", "certify-lipschitz"):
        sp = add(name, "certify", help=f"{name.split('-')[1]} certificate")
        sp.add_argument("--run-dir", required=True, help=RESTORE_HELP)
        sp.add_argument("--max-images", type=int, default=None)
        sp.add_argument("--image-batch", type=int, default=None,
                        help="stream the sweep in image batches with "
                        "running clean/certified counts")
        sp.add_argument("--stream-out", default=None,
                        help="append per-batch JSON lines here; summary "
                        "written to <path>.json")

    sp = sub.add_parser("summarize-stream", help="fold a certify stream log")
    sp.add_argument("stream", help="certify_stream JSONL audit log")
    sp.add_argument("--out", default=None,
                    help="write merged summary JSON here (default: print)")

    sp = add("eval-autoattack", "certify", help="AutoAttack robust accuracy")
    sp.add_argument("--run-dir", required=True, help=RESTORE_HELP)
    sp.add_argument("--max-images", type=int, default=None)
    sp.add_argument("--attacks", default="apgd-ce,apgd-t,fab-t,square")
    sp.add_argument("--out", default=None,
                    help="write a JSON artifact (knobs, robust_idx, "
                    "throughput) here")

    sp = sub.add_parser("data-check", help="verify a real dataset's files")
    sp.add_argument("--dataset", default="CIFAR10",
                    help="MNIST / FashionMNIST / CIFAR10 / CIFAR3")
    sp.add_argument("--data-root", default="data")

    sp = add("segway-train", help="train the Segway safe controller")
    sp.add_argument("--save", default="run_data/segway.npz")
    sp.add_argument("--iters", type=int, default=300)
    sp.add_argument("--no-adv", action="store_true")
    sp.add_argument("--resume", action="store_true",
                    help="continue from SAVE.resume.pt")

    sp = add("segway-certify", help="certify the Segway safe controller")
    sp.add_argument("--model", default="run_data/segway.npz")
    sp.add_argument("--r", type=float, default=0.01)
    sp.add_argument("--level", type=float, default=0.15)
    sp.add_argument("--plot-dir", default=None,
                    help="write the Vdot phase-plane and 3-D trajectory "
                    "figures here")
    return p


def _data_check(args):
    from .train.data import check_data_root

    report = check_data_root(args.dataset, args.data_root)
    print(json.dumps(report, indent=1))
    if not report["ok"]:
        print("\nNOT READY: " + "; ".join(report["errors"]), file=sys.stderr)
        sys.exit(1)
    print(
        "\nReal {0} files verified. The accuracy-parity protocol is one "
        "command per stage:\n"
        "  python -m fiode_tpu_torch train --config-name cifar_train.yaml "
        "--run-dir run_data/real ++data_root={1}\n"
        "  python -m fiode_tpu_torch certify-crown --config-name "
        "cifar_certify.yaml --run-dir run_data/real ++data_root={1} "
        "--image-batch 16 --stream-out run_data/real/certify_stream.jsonl\n"
        "  python -m fiode_tpu_torch eval-autoattack --config-name "
        "cifar_certify.yaml --run-dir run_data/real ++data_root={1} "
        "--out run_data/real/autoattack.json".format(args.dataset,
                                                     args.data_root))


def main(argv=None):
    args = _parser().parse_args(argv)

    if args.cmd == "train":
        from .experiment import run_train

        run_dir, device = args.run_dir, args.device
        if args.multihost:
            from .parallel.multihost import bootstrap_multihost, local_device

            device = local_device(device)
            idx, count = bootstrap_multihost(device)
            print(f"[multihost] process {idx}/{count} on {device}", flush=True)
            if idx and run_dir:
                # one writer per artifact: process i > 0 keeps its own
                # log and checkpoints
                run_dir = f"{run_dir}/proc{idx}"
        cfg = _compose(args, "train")
        try:
            run_train(cfg, run_dir=run_dir, epochs=args.epochs,
                      test_adv=args.test_adv, resume=args.resume, device=device)
        finally:
            if args.multihost:
                from .parallel.multihost import shutdown_multihost
                shutdown_multihost()
    elif args.cmd == "sample-grid":
        from .experiment import run_sample_grid_config

        run_sample_grid_config(_compose(args, "certify"), out_path=args.out)
    elif args.cmd in ("certify-crown", "certify-lipschitz"):
        from .experiment import run_certify_config

        run_certify_config(
            _compose(args, "certify"), method=args.cmd.split("-")[1],
            run_dir=args.run_dir, max_images=args.max_images,
            image_batch=args.image_batch, stream_out=args.stream_out,
            device=args.device)
    elif args.cmd == "summarize-stream":
        from .verify.certify import summarize_stream

        print(json.dumps(summarize_stream(args.stream, out_path=args.out),
                         indent=2))
    elif args.cmd == "eval-autoattack":
        from .experiment import run_autoattack_config

        run_autoattack_config(
            _compose(args, "certify"), run_dir=args.run_dir,
            max_images=args.max_images,
            attacks=tuple(a.strip() for a in args.attacks.split(",")
                          if a.strip()),
            out_path=args.out, device=args.device)
    elif args.cmd == "data-check":
        _data_check(args)
    elif args.cmd == "segway-train":
        from .control.train_segway import SegwayTrainConfig, train_segway

        cfg = SegwayTrainConfig(adv_train=not args.no_adv,
                                fit_lqr_iters=args.iters,
                                barrier_iters=args.iters)
        train_segway(cfg, save_path=args.save, resume=args.resume,
                     device=args.device)
    elif args.cmd == "segway-certify":
        from .control.certify_segway import certify_segway

        certify_segway(args.model, r=args.r, level=args.level,
                       plot_dir=args.plot_dir, device=args.device)


if __name__ == "__main__":
    main()
