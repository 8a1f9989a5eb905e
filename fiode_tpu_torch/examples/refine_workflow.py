"""Branch-and-bound refinement of a completed CROWN sweep's uncertified
images, on the card (counterpart of examples/refine_workflow.py).

    python -m fiode_tpu_torch.examples.refine_workflow \\
        --run-dir run_data/certified_full --images 15 --rounds 2

It reads the sweep's summary for the certified set, refines every clean
but uncertified image (``verify.refine.refine_uncertified``: each image's
grid is swept again and its violated cells split until every box closes
or a budget trips) and writes ``refine_full.json`` with per-image stats
and the upgraded certified set: a self-contained certificate for every
image it flips.

Resumable: every image's verdict is appended to ``<out-stem>_stream.jsonl``
with this run's budgets stamped on it.  A rerun skips certified images
and the give-ups of the same budgets, and retries give-ups recorded under
other budgets.  ``seconds`` is this process's wall time.

``--order-by-witness`` (default: ``<run-dir>/exact_witnesses.json`` when
it exists) schedules the images by descending exact margin from a
``refute_witnesses`` audit and skips its refuted images; ``--images``
lists the images to refine, in order, and overrides the refuted skip.

The flags are the JAX driver's, with these differences:

  * ``--device-cap`` is left behind with the JAX package's device BaB path
    (the port keeps one frontier on the device at any size), and so is the
    ``qp_method`` stamp (the port takes the QP method as an argument, not
    from ``FIODE_QP_METHOD``);
  * ``matmul_precision`` is "float32": the port certifies in float32 only;
  * ``--run-dir`` is only read (best parameters, ``--summary``, the
    witness audit); the JSON and its sidecar go under ``--out-dir``
    (default ``run_data/torch/refine_workflow``); ``--device`` defaults to
    cuda.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

import numpy as np

from ._common import (add_run_options, append_stream, certifier,
                      certify_setup, device_of, out_dir, read_stream,
                      summary_range)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--run-dir", default="run_data/certified_full")
    ap.add_argument("--summary", default="certify_stream_full.summary.json")
    ap.add_argument("--config-name", default="cifar_certify.yaml")
    ap.add_argument("overrides", nargs="*",
                    help="++key=value config overrides (e.g. ++T=6)")
    ap.add_argument("--end", type=int, default=512)
    ap.add_argument("--rounds", type=int, default=40)
    ap.add_argument("--collect-cap", type=int, default=4_000_000)
    ap.add_argument("--box-budget", type=int, default=64_000_000)
    ap.add_argument("--frontier-cap", type=int, default=1 << 20)
    ap.add_argument("--alpha-iters", type=int, default=0,
                    help="alpha-CROWN slope iterations in the box evaluator "
                    "(0 = plain CROWN)")
    ap.add_argument("--lips-box", action="store_true",
                    help="bound every cell and box by min(CROWN, exact "
                    "centre + local Lipschitz): never looser than CROWN, "
                    "one exact forward (K1) more per box")
    ap.add_argument("--image-seconds", type=float, default=None,
                    help="per-image wall-clock cap (gave_up=time_budget)")
    ap.add_argument("--images", default=None,
                    help="comma-separated test indices to refine, in this "
                    "order (others are skipped)")
    ap.add_argument("--order-by-witness", nargs="?", metavar="WITNESS_JSON",
                    const="exact_witnesses.json", default="auto",
                    help="schedule by descending exact margin from a "
                    "refute_witnesses audit (relative to --run-dir) and skip "
                    "its refuted images; default: <run-dir>/"
                    "exact_witnesses.json when present")
    ap.add_argument("--no-witness-order", action="store_true",
                    help="index order, refuted images not skipped")
    ap.add_argument("--chunk", type=int, default=8192)
    ap.add_argument("--superchunk", type=int, default=16)
    ap.add_argument("--out", default="refine_full.json")
    add_run_options(ap, "refine_workflow")
    return ap


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    device = device_of(args.device)
    out = out_dir(args)

    from ..verify.refine import RefineStats, refine_uncertified

    run_dir = Path(args.run_dir)
    summary = json.loads((run_dir / args.summary).read_text())
    idx_max = summary_range(summary)
    cfg, model, ds = certify_setup(args, device)
    end = min(args.end, idx_max + 1, len(ds.test_x))

    certified = np.zeros(end, bool)
    certified[[i for i in summary["certified_idx"] if i < end]] = True
    base_mask = certified.copy()
    base_certified = int(base_mask.sum())

    # a certified verdict is final under any budget; a give-up is final only
    # under the budgets it was recorded with
    budget_params = {
        "rounds": args.rounds,
        "collect_cap": args.collect_cap,
        "box_budget": args.box_budget,
        "frontier_cap": args.frontier_cap,
        "alpha_iters": args.alpha_iters,
        "lips_box": args.lips_box,
        "image_seconds": args.image_seconds,
    }
    out_path = out / args.out
    stream_path = out_path.with_name(out_path.stem + "_stream.jsonl")
    streamed = read_stream(stream_path)
    skip = np.zeros(end, bool)
    resumed = np.zeros(end, bool)  # streamed verdicts this run keeps
    for i, rec in streamed.items():
        if i < end and (rec["certified"] or rec.get("params") == budget_params):
            certified[i] |= bool(rec["certified"])
            skip[i] = resumed[i] = True
    if streamed:
        print(f"resuming: {len(streamed)} streamed verdicts "
              f"({sum(r['certified'] for r in streamed.values())} certified, "
              f"retrying {sum(1 for i in streamed if i < end and not resumed[i])} "
              "give-ups under new budgets)", flush=True)

    order, refuted = None, set()
    wit_arg = None if args.no_witness_order else args.order_by_witness
    if wit_arg == "auto":
        wit_arg = ("exact_witnesses.json"
                   if (run_dir / "exact_witnesses.json").exists() else None)
    if wit_arg is not None:
        audit = json.loads((run_dir / wit_arg).read_text())
        ws = sorted(audit["witnesses"], key=lambda w: -w["exact_margin"])
        order = [int(w["image"]) for w in ws
                 if w["verdict"] == "tractable" and 0 <= int(w["image"]) < end]
        refuted = {int(w["image"]) for w in ws
                   if w["verdict"] == "refuted" and 0 <= int(w["image"]) < end}
        skip[sorted(refuted)] = True
        print(f"witness audit ({wit_arg}): skipping {len(refuted)} refuted "
              f"images, scheduling {len(order)} tractable by descending "
              "margin", flush=True)
    if args.images is not None:
        order = [int(s) for s in args.images.split(",") if s.strip()]
        out_of_range = sorted(i for i in order if not 0 <= i < end)
        if out_of_range:
            raise SystemExit(f"--images indices out of range: {out_of_range}")
        # the listed images are refined even where the audit refuted them
        # (the resumed verdicts still hold)
        for i in sorted(set(order) & refuted):
            skip[i] = resumed[i]
        skip |= ~np.isin(np.arange(end), order)

    cert = certifier(cfg, model)
    print(f"refining {int((~certified & ~skip).sum())} uncertified of {end} "
          f"images (T={cert.T}, kappa={cert.kappa:.4f}, "
          f"precision={cert.matmul_precision}, rounds<={args.rounds}, "
          f"alpha_iters={args.alpha_iters})", flush=True)
    t0 = time.time()

    new_cert, stats = refine_uncertified(
        cert, ds.test_x[:end], ds.test_y[:end], certified,
        max_rounds=args.rounds, collect_cap=args.collect_cap,
        box_budget=args.box_budget, frontier_cap=args.frontier_cap,
        alpha_iters=args.alpha_iters, lips_box=args.lips_box,
        image_seconds=args.image_seconds, chunk=args.chunk,
        superchunk=args.superchunk, progress_every=1, skip=skip,
        on_image=lambda s: append_stream(
            stream_path, dataclasses.asdict(s) | {"params": budget_params}),
        order=order)
    # the resumed images' stats, read as RefineStats (the budget stamp is
    # the driver's, not a stat)
    fields = {f.name for f in dataclasses.fields(RefineStats)}
    fresh = {s.image for s in stats}
    stats = sorted(stats + [
        RefineStats(**{k: v for k, v in rec.items() if k in fields})
        for i, rec in streamed.items()
        if i < end and i not in fresh and skip[i]], key=lambda s: s.image)
    result = {
        "base_summary": args.summary,
        "n_images": end,
        "matmul_precision": cert.matmul_precision,
        "refine_rounds": args.rounds,
        "box_budget": args.box_budget,
        "collect_cap": args.collect_cap,
        "frontier_cap": args.frontier_cap,
        "alpha_iters": args.alpha_iters,
        "lips_box": args.lips_box,
        "base_certified": base_certified,
        "certified": int(new_cert.sum()),
        "recovered": int(new_cert.sum() - base_certified),
        "certified_acc": float(new_cert.mean()),
        "recovered_idx": sorted(np.nonzero(new_cert & ~base_mask)[0].tolist()),
        "certified_idx": sorted(np.nonzero(new_cert)[0].tolist()),
        "seconds": time.time() - t0,
        "stats": [dataclasses.asdict(s) for s in stats],
    }
    out_path.write_text(json.dumps(result, indent=1))
    print(f"certified {result['base_certified']} -> {result['certified']} "
          f"(+{result['recovered']}) of {end} [{result['certified_acc']:.4f}] "
          f"in {result['seconds']:.0f}s -> {out_path}", flush=True)
    return result


if __name__ == "__main__":
    main()
