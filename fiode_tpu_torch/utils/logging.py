"""Metric logging to ``<run_dir>/metrics.jsonl`` and the console
(counterpart of ``fiode_tpu/utils/logging.py``; no wandb: the port's
machines have no network).

One JSON object per ``log`` call, tagged with step, epoch and seconds since
the writer opened; ``config.json`` records the training config once and is
never overwritten (a differing config on an existing run directory is
reported, not written).
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path
from typing import Optional

__all__ = ["MetricWriter"]


class MetricWriter:
    def __init__(self, run_dir: str, config: Optional[dict] = None,
                 quiet: bool = False):
        self.run_dir = Path(run_dir)
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self._fh = open(self.run_dir / "metrics.jsonl", "a")
        self._t0 = time.time()
        self.quiet = quiet
        if config is not None:
            cfg_path = self.run_dir / "config.json"
            serialized = json.dumps(config, indent=2, default=str)
            if not cfg_path.exists():
                cfg_path.write_text(serialized)
            elif cfg_path.read_text() != serialized:
                print(
                    f"[logging] WARNING: {cfg_path} differs from this run's "
                    "config; keeping the original record (delete the file "
                    "or use a fresh run dir to retrain with new settings)",
                    flush=True,
                )

    def log(self, metrics: dict, step: int, epoch: Optional[int] = None):
        rec = {"step": int(step), "t": round(time.time() - self._t0, 3)}
        if epoch is not None:
            rec["epoch"] = int(epoch)
        rec.update({k: (float(v) if hasattr(v, "__float__") else v)
                    for k, v in metrics.items()})
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    def console(self, msg: str):
        if not self.quiet:
            print(msg, file=sys.stderr, flush=True)

    def close(self):
        self._fh.close()
