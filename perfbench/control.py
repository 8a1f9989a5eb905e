"""The output check's two readings for one cell, on the card: for each
seed, a run's set-up and a window of ``--seconds`` at the cell's own load,
then the numbers the check compares for the program (the lower reading)
and for each control or fault of the cell's mix (``controls``: the
reference put in the program's place, computed one precision lower or
with the fault planted), one JSON line per seed.  The benchmark's own runs
do not run it.

    python3 perfbench/control.py --workload <name> --seconds 2 --seeds 1 2 3
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import harness  # noqa: E402


def readings(cell: dict, seed: int, seconds: float, device: str,
             controls=None) -> dict:
    """{"program": numbers, <control>: numbers, ...} for one seed."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = harness.load_module("traffic", cell["mix"]["generator"])
    st = gen.setup(cell, seed, device)
    gen.window(st, seconds)
    out = {"seed": seed, "attempted": st.window["attempted"],
           "failed": gen.failures(st)}
    gen.release(st)
    out["program"] = gen.check(st)
    for c in cell["mix"]["controls"] if controls is None else controls:
        out[c] = gen.check(st, control=c)
    del st
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--controls", nargs="*", default=None)
    ap.add_argument("--control-seeds", type=int, default=3,
                    help="read the controls on the first this many seeds")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        harness.log("perfbench/control.py: no CUDA device")
        return 2
    cell = harness.cell(harness.load_manifest(ROOT), args.workload)
    for i, seed in enumerate(args.seeds):
        controls = args.controls if i < args.control_seeds else []
        print(json.dumps(readings(cell, seed, args.seconds, "cuda",
                                  controls)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
