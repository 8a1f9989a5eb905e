"""One run of one cell of the benchmark of fiode_tpu_torch on NVIDIA GPUs.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell is looked up in ``BENCHMARK.json``;
its configuration, traffic mix, traffic generator and metric readers are
found by name under ``perfbench/`` (``harness.py`` says where).  A run:

  1. builds the program's objects from the seed on the card and warms up
     every shape the window uses (set-up, ``setup_s``: from the process's
     start to the window's start);
  2. runs the traffic for ``--seconds`` (the window);
  3. with ``--trace 1``, profiles a slice of a few more iterations of the
     same loop after the window (torch.profiler), and reads the cell's
     per-layer metrics; with ``--trace 0`` its end-to-end metrics;
  4. reads the peak device memory, frees the program's state, and holds
     the answers of the window against the plain reference
     (``perfbench/reference``): each number compared beside its limit, on
     stderr and last in the result line;
  5. prints one JSON line, the result.

It exits non-zero without a result when there is no card, fewer cards than
the cell asks for, or when a module of JAX, flax or the JAX package
(``fiode_tpu``, compared as a whole top-level name) is loaded.  The
program's kernel builds and every cache a run writes live under
``build/`` in the checkout.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import harness  # noqa: E402

CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TRITON_CACHE_DIR": "triton", "CUDA_CACHE_PATH": "nv"}


def run(cell: dict, seed: int, seconds: float, trace: bool, device: str,
        clock) -> dict:
    """One run of ``cell`` on ``device``; returns the result's fields."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    on_card = torch.device(device).type == "cuda"
    gen = harness.load_module("traffic", cell["mix"]["generator"])
    st = gen.setup(cell, seed, device)
    setup_s = clock()
    gen.window(st, seconds)
    prof = harness.profiled(lambda: gen.traced_slice(st)) if trace else None
    ctx = harness.Context(cell, st, setup_s, prof)
    metrics = {}
    for m in cell["per_layer"] if trace else cell["end_to_end"]:
        value = harness.load_module("metrics", m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    failed = gen.failures(st)
    info = {"platform": "gpu" if on_card else "cpu",
            "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
            "count": cell["workload"]["chips"],
            "memory_peak_bytes": (torch.cuda.max_memory_allocated()
                                  if on_card else 0)}
    if prof is not None:
        info["busy_s"], info["window_s"] = prof.busy_s(), prof.window_s
    gen.release(st)
    checks = gen.check(st)
    limits = cell["mix"]["limits"]
    if set(checks) != set(limits):
        raise KeyError(f"the check compared {sorted(checks)}, the mix has "
                       f"limits for {sorted(limits)}")
    result = {"correct": all(checks[k] <= limits[k] for k in limits),
              "attempted": st.window["attempted"], "failed": failed,
              "metrics": metrics, "device": info}
    if prof is not None:
        result["breakdown"] = prof.breakdown()
    result["checks"] = {k: {"value": checks[k], "limit": limits[k]}
                        for k in limits}
    return result


def main(argv=None) -> int:
    clock = harness.Clock()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for key, sub in CACHES.items():
        os.environ[key] = str(ROOT / "build" / "perfbench" / sub)
    cell = harness.cell(harness.load_manifest(ROOT), args.workload)

    import torch
    chips = cell["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        harness.log(f"perfbench: {args.workload} needs {chips} CUDA device(s); "
                    f"found {torch.cuda.device_count()}")
        return 2
    torch.set_num_threads(4)
    result = run(cell, args.seed, args.seconds, bool(args.trace), "cuda", clock)
    bad = harness.forbidden_modules()
    if bad:
        harness.log(f"perfbench: the run loaded {bad}: JAX, flax or the JAX "
                    "package must not be loaded")
        return 3
    for k, c in result["checks"].items():
        harness.log(f"check {k}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
