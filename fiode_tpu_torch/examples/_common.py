"""What the example drivers share: their ``--device`` and ``--out-dir``
options, the configs, a restored model with its certifier, and the JSONL
sidecars that make the long drivers resumable."""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from ..cli import CONFIG_DIRS
from ..utils.config import compose

__all__ = ["CONFIG_DIRS", "add_run_options", "device_of", "out_dir",
           "compose", "certify_setup", "certifier", "read_stream",
           "append_stream", "summary_range"]


def add_run_options(ap: argparse.ArgumentParser, driver: str,
                    *aliases: str) -> None:
    """``--device`` (default cuda) and ``--out-dir`` (default
    ``run_data/torch/<driver>``, which ``.gitignore`` covers): every file a
    driver writes goes under ``--out-dir``, never into ``--run-dir``."""
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; no fallback "
                    "to the CPU)")
    ap.add_argument("--out-dir", *aliases, dest="out_dir",
                    default=f"run_data/torch/{driver}",
                    help="directory every output of this driver goes to")


def device_of(name: str) -> torch.device:
    """``name`` as a device; a CUDA device on a machine without one raises
    (a driver never moves to the CPU unasked)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device is available "
                           "(pass --device cpu to run on the CPU)")
    return device


def out_dir(args) -> Path:
    path = Path(args.out_dir)
    path.mkdir(parents=True, exist_ok=True)
    return path


def certify_setup(args, device, config_name=None, config_dir=None):
    """(cfg, model, dataset): the composed certify config with the driver's
    overrides, its model with ``--run-dir``'s best parameters (eval mode,
    on ``device``) and its dataset."""
    from ..experiment import _load_cfg_dataset, restore_model

    cfg = compose(config_name or args.config_name, args.overrides,
                  config_dir or str(CONFIG_DIRS["certify"]))
    return cfg, restore_model(cfg, args.run_dir, device), _load_cfg_dataset(cfg)


def certifier(cfg, model, **kw):
    """The ``Certifier`` of a certify config: its T, eps and the dynamics'
    scale_nominal."""
    from ..verify.certify import Certifier

    return Certifier(model, T=int(cfg.get("T", 40)),
                     eps_input=float(cfg.get("eps", 36 / 255)),
                     scale_nominal=bool(cfg["module"]["dynamics"]["scale_nominal"]),
                     **kw)


def read_stream(path: Path) -> dict:
    """{image: record} of a JSONL sidecar; a line cut short by a killed
    process is skipped with a warning (that image is done again)."""
    streamed = {}
    if not path.exists():
        return streamed
    for ln, line in enumerate(path.read_text().splitlines(), 1):
        if not line.strip():
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            print(f"warning: {path}:{ln} is malformed JSON (truncated "
                  "write?); ignoring that record", flush=True)
            continue
        streamed[int(rec["image"])] = rec
    return streamed


def append_stream(path: Path, rec: dict) -> None:
    with path.open("a") as fh:
        fh.write(json.dumps(rec) + "\n")


def summary_range(summary: dict) -> int:
    """The last test index a sweep summary covers; it must start at 0
    (summarize_stream's index_min / index_max, or certify_stream's
    start_ind + n_images)."""
    idx_min = int(summary.get("index_min", summary.get("start_ind", 0)))
    idx_max = int(summary.get("index_max", idx_min + int(summary["n_images"]) - 1))
    if idx_min != 0:
        raise SystemExit(f"summary covers indices {idx_min}..{idx_max}; this "
                         "driver takes test indices from 0 (re-run the sweep "
                         "with ++start_ind=0)")
    return idx_max
