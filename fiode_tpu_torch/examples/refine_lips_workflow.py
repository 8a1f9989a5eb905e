"""Local refinement of the Lipschitz certificate over a completed sweep, on
the card (counterpart of examples/refine_lips_workflow.py).

    python -m fiode_tpu_torch.examples.refine_lips_workflow \\
        --run-dir run_data/certified_full --end 16 --rounds 2

It reads a Lipschitz stream summary (``lips_stream_full.jsonl.json``: the
certified set with the grid-gap slack, the larger-T exact set and the
clean set) and refines, with ``verify.refine_lips.refine_lips_uncertified``,
every clean image whose exact grid values pass but whose slack fails: the
only tier refinement can help.  An exact lattice violation cannot be
refined and is recorded as ``exact_violation`` without work.  Each image's
grid is swept again, so the output certifies every image it flips by
itself.

Resumable as ``refine_workflow``: per-image verdicts stream to
``<out-stem>_stream.jsonl`` with the budgets stamped; a rerun skips
certified images, exact violations and give-ups of the same budgets.

The flags are the JAX driver's, plus positional ``++key=value``
overrides.  ``--run-dir`` is only read (best parameters and
``--summary``); the JSON and its sidecar go under ``--out-dir`` (default
``run_data/torch/refine_lips_workflow``).  ``--device`` defaults to cuda.
On the card every cell and box centre goes through K1.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

import numpy as np

from ._common import (add_run_options, append_stream, certifier,
                      certify_setup, device_of, out_dir, read_stream)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--run-dir", default="run_data/certified_full")
    ap.add_argument("--summary", default="lips_stream_full.jsonl.json")
    ap.add_argument("--config-name", default="cifar_certify.yaml")
    ap.add_argument("--end", type=int, default=512)
    ap.add_argument("--rounds", type=int, default=60)
    ap.add_argument("--collect-cap", type=int, default=12_000_000)
    ap.add_argument("--box-budget", type=int, default=128_000_000)
    ap.add_argument("--frontier-cap", type=int, default=1 << 25)
    ap.add_argument("--chunk", type=int, default=8192)
    ap.add_argument("--superchunk", type=int, default=16)
    ap.add_argument("--out", default="refine_lips_full.json")
    ap.add_argument("overrides", nargs="*",
                    help="++key=value config overrides (e.g. ++T=6)")
    add_run_options(ap, "refine_lips_workflow")
    return ap


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    device = device_of(args.device)
    out = out_dir(args)

    from ..verify.refine import RefineStats
    from ..verify.refine_lips import refine_lips_uncertified

    summary = json.loads((Path(args.run_dir) / args.summary).read_text())
    if summary.get("method", "lipschitz") != "lipschitz":
        raise SystemExit("summary is not a lipschitz-sweep artifact")
    start = int(summary.get("start_ind", 0))
    if start != 0:
        raise SystemExit(f"summary covers indices from {start}; this driver "
                         "refines test indices from 0 (re-run the sweep with "
                         "++start_ind=0)")
    cfg, model, ds = certify_setup(args, device)
    end = min(args.end, int(summary["n_images"]), len(ds.test_x))

    def mask_from(key):
        m = np.zeros(end, bool)
        m[[i for i in summary[key] if i < end]] = True
        return m

    certified = mask_from("certified_idx")
    exact_ok = mask_from("larger_T_certified_idx")
    clean = mask_from("clean_idx")
    base_mask = certified.copy()
    base_certified = int(base_mask.sum())

    budget_params = {
        "rounds": args.rounds,
        "collect_cap": args.collect_cap,
        "box_budget": args.box_budget,
        "frontier_cap": args.frontier_cap,
    }
    stream_path = out / (Path(args.out).stem + "_stream.jsonl")
    streamed = read_stream(stream_path)
    skip = np.zeros(end, bool)
    for i, rec in streamed.items():
        if i < end and (rec["certified"] or rec["gave_up"] == "exact_violation"
                        or rec.get("params") == budget_params):
            certified[i] |= bool(rec["certified"])
            skip[i] = True  # an exact violation holds under any budget
    if streamed:
        print(f"resuming: {len(streamed)} streamed verdicts "
              f"({sum(r['certified'] for r in streamed.values())} certified, "
              f"retrying {sum(1 for i in streamed if i < end and not skip[i])} "
              "give-ups under new budgets)", flush=True)

    cert = certifier(cfg, model)
    todo = int((clean & exact_ok & ~certified & ~skip).sum())
    print(f"lips-refining {todo} slack-blocked images of {end} "
          f"(+{int((clean & ~exact_ok & ~skip).sum())} exact-violation "
          f"fast-skips; T={cert.T}, kappa_lips={cert.kappa_lips:.4f}, "
          f"precision={cert.matmul_precision}, rounds<={args.rounds})",
          flush=True)
    t0 = time.time()

    new_cert, stats = refine_lips_uncertified(
        cert, ds.test_x[:end], ds.test_y[:end], certified,
        exact_ok=exact_ok, clean=clean, max_rounds=args.rounds,
        collect_cap=args.collect_cap, box_budget=args.box_budget,
        frontier_cap=args.frontier_cap, chunk=args.chunk,
        superchunk=args.superchunk, progress_every=1, skip=skip,
        on_image=lambda s: append_stream(
            stream_path, dataclasses.asdict(s) | {"params": budget_params}))
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
        **budget_params,
        "base_certified": base_certified,
        "certified": int(new_cert.sum()),
        "recovered": int(new_cert.sum() - base_certified),
        "certified_acc": float(new_cert.mean()),
        "exact_ok": int(exact_ok.sum()),
        "recovered_idx": sorted(np.nonzero(new_cert & ~base_mask)[0].tolist()),
        "certified_idx": sorted(np.nonzero(new_cert)[0].tolist()),
        "seconds": time.time() - t0,
        "stats": [dataclasses.asdict(s) for s in stats],
    }
    (out / args.out).write_text(json.dumps(result, indent=1))
    print(f"lips-certified {result['base_certified']} -> {result['certified']} "
          f"(+{result['recovered']}) of {end} [{result['certified_acc']:.4f}] "
          f"in {result['seconds']:.0f}s -> {out / args.out}", flush=True)
    return result


if __name__ == "__main__":
    main()
