"""Full-grid hybrid sweep on the card (counterpart of
examples/hybrid_sweep.py): every cell under min(CROWN, exact centre +
local Lipschitz), ``verify.refine.hybrid_base_sweep``, the strongest
single-pass certificate, one verdict per image.

    python -m fiode_tpu_torch.examples.hybrid_sweep \\
        --run-dir run_data/certified_full --images 502

The hybrid bound is the pointwise minimum of two sound bounds, so every
image of the CROWN sweep's ``certified_idx`` is hybrid-certified a
fortiori: by default the sweep covers the summary's clean-but-uncertified
images (``--images`` overrides).  ``certified_total`` = |CROWN certified| +
|newly hybrid-certified|.

Resumable: per-image records append to ``<out-stem>_stream.jsonl`` under
``--out-dir``, and a rerun skips every image streamed there (a sweep's
verdict is deterministic).

The flags are the JAX driver's.  ``--run-dir`` is only read (its best
parameters and ``--summary``); the JSON and its sidecar go under
``--out-dir`` (default ``run_data/torch/hybrid_sweep``).  ``--device``
defaults to cuda.  On the card every cell's exact centre goes through K1.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

import numpy as np

from ._common import (CONFIG_DIRS, add_run_options, append_stream,
                      certifier, certify_setup, device_of, out_dir,
                      read_stream, summary_range)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--run-dir", default="run_data/certified_full")
    ap.add_argument("--summary", default="certify_stream_full.summary.json")
    ap.add_argument("--config-name", default="cifar_certify.yaml")
    ap.add_argument("--config-dir", default=str(CONFIG_DIRS["certify"]))
    ap.add_argument("overrides", nargs="*",
                    help="++key=value config overrides (e.g. ++T=6)")
    ap.add_argument("--end", type=int, default=512)
    ap.add_argument("--images", default=None,
                    help="comma-separated test indices to sweep (default: "
                    "the summary's clean-but-uncertified images)")
    ap.add_argument("--chunk", type=int, default=8192)
    ap.add_argument("--superchunk", type=int, default=16)
    ap.add_argument("--out", default="hybrid_sweep.json")
    add_run_options(ap, "hybrid_sweep")
    return ap


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    device = device_of(args.device)
    out = out_dir(args)

    from ..verify.refine import hybrid_base_sweep

    summary = json.loads((Path(args.run_dir) / args.summary).read_text())
    idx_max = summary_range(summary)
    cfg, model, ds = certify_setup(args, device, config_dir=args.config_dir)
    end = min(args.end, idx_max + 1, len(ds.test_x))

    crown_certified = np.zeros(end, bool)
    crown_certified[[i for i in summary["certified_idx"] if i < end]] = True

    stream_path = out / (Path(args.out).stem + "_stream.jsonl")
    streamed = read_stream(stream_path)
    done = np.isin(np.arange(end), [i for i in streamed if i < end])
    skip = crown_certified | done  # dominated, or already streamed
    if args.images is not None:
        want = {int(s) for s in args.images.split(",") if s.strip()}
        out_of_range = sorted(i for i in want if not 0 <= i < end)
        if out_of_range:
            raise SystemExit(f"--images indices out of range: {out_of_range}")
        skip = ~np.isin(np.arange(end), sorted(want)) | done

    cert = certifier(cfg, model)
    print(f"hybrid sweep over {int((~skip).sum())} images of {end} "
          f"(T={cert.T}, kappa={cert.kappa:.4f}, "
          f"precision={cert.matmul_precision}; "
          f"{int(crown_certified.sum())} CROWN-certified skipped as "
          f"dominated, {len(streamed)} resumed)", flush=True)
    t0 = time.time()

    def stream_image(s):
        append_stream(stream_path, dataclasses.asdict(s))
        print(f"[hybrid] img {s.image} worst={s.worst:+.4f} "
              f"violated={s.n_violated} certified={s.certified} "
              f"({s.seconds:.1f}s)", flush=True)

    stats = hybrid_base_sweep(cert, ds.test_x[:end], ds.test_y[:end],
                              chunk=args.chunk, superchunk=args.superchunk,
                              skip=skip, on_image=stream_image)
    all_recs = {s.image: dataclasses.asdict(s) for s in stats}
    for i, rec in streamed.items():
        if i < end:
            all_recs.setdefault(i, rec)
    newly = sorted(i for i, r in all_recs.items() if r["certified"])
    result = {
        "base_summary": args.summary,
        "n_images": end,
        "matmul_precision": cert.matmul_precision,
        "T": cert.T,
        "kappa": cert.kappa,
        "crown_certified": int(crown_certified.sum()),
        "swept": sorted(all_recs),
        "hybrid_certified_new": newly,
        # CROWN-certified images are hybrid-certified a fortiori
        "certified_total": int(crown_certified.sum()) + len(
            [i for i in newly if not crown_certified[i]]),
        "seconds": time.time() - t0,
        "stats": [all_recs[i] for i in sorted(all_recs)],
    }
    (out / args.out).write_text(json.dumps(result, indent=1))
    print(f"hybrid sweep: CROWN base {result['crown_certified']} -> "
          f"hybrid base {result['certified_total']} "
          f"(+{len(newly)} of {len(all_recs)} swept) "
          f"in {result['seconds']:.0f}s -> {out / args.out}", flush=True)
    return result


if __name__ == "__main__":
    main()
