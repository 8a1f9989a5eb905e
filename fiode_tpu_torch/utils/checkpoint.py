"""Checkpoints of a training run under ``<run_dir>/ckpt`` (counterpart of
``fiode_tpu/utils/checkpoint.py``).

  * ``best.npz`` / ``best.json``: the parameters of the epoch with the best
    monitored validation value (``mode`` min or max), a flat ``.npz`` under
    the flax names (``bridge.save_npz``), so ``entry.certify_model(
    checkpoint=...)`` and the JAX package read it; the watermark in
    ``best.json`` survives a reopen, so a resumed run cannot let a worse
    epoch take the slot;
  * ``last.npz`` / ``last.json``: the latest evaluated epoch's parameters;
  * ``resume.pt`` / ``resume.json``: the whole training state (module state,
    optimizer state, generator states, step and epoch) written with
    ``torch.save`` and read back with ``weights_only=True``.

``CheckpointManager.best_path(run_dir)`` is where a run directory's best
parameters are read from: ``ckpt/best.npz`` (this package's), else
``ckpt/best_torch.npz`` (a JAX checkpoint exported by
``tools/export_torch_checkpoint.py``).
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

import torch
from torch import nn

from ..bridge import load_npz, save_npz

__all__ = ["CheckpointManager", "BEST_FILES"]

# the files a run directory's best parameters are read from, in order
BEST_FILES = ("best.npz", "best_torch.npz")


class CheckpointManager:
    def __init__(self, run_dir: str, monitor: str = "validation_error",
                 mode: str = "min"):
        self.dir = Path(run_dir) / "ckpt"
        self.dir.mkdir(parents=True, exist_ok=True)
        self.monitor = monitor
        self.mode = mode
        self.best: Optional[float] = None
        best_json = self.dir / "best.json"
        if best_json.exists():
            try:
                self.best = float(json.loads(best_json.read_text())[monitor])
            except (KeyError, ValueError):
                pass

    @staticmethod
    def best_path(run_dir) -> Path:
        """The first of ``BEST_FILES`` under ``run_dir/ckpt``; raises
        ``FileNotFoundError`` naming both when neither exists."""
        paths = [Path(run_dir) / "ckpt" / f for f in BEST_FILES]
        for p in paths:
            if p.exists():
                return p
        raise FileNotFoundError(
            "no best checkpoint: neither " + " nor ".join(map(str, paths))
            + " exists")

    def path(self, name: str) -> Path:
        """The parameter file of checkpoint ``name`` ("best" or "last")."""
        return self.dir / f"{name}.npz"

    def save_last(self, model: nn.Module, metrics: dict, step: int):
        save_npz(model, self.path("last"))
        (self.dir / "last.json").write_text(json.dumps(
            {"step": step, **{k: float(v) for k, v in metrics.items()}}))

    def maybe_save_best(self, model: nn.Module, metrics: dict,
                        step: int) -> bool:
        val = float(metrics[self.monitor])
        better = (self.best is None
                  or (self.mode == "min" and val < self.best)
                  or (self.mode == "max" and val > self.best))
        if better:
            self.best = val
            save_npz(model, self.path("best"))
            (self.dir / "best.json").write_text(
                json.dumps({"step": step, self.monitor: val}))
        return better

    def restore(self, model: nn.Module, name: str = "best") -> nn.Module:
        """Load checkpoint ``name``'s parameters into ``model`` in place."""
        return load_npz(model, self.path(name))

    def save_resume(self, state: dict, epoch: int, step: int):
        torch.save(state, self.dir / "resume.pt")
        (self.dir / "resume.json").write_text(
            json.dumps({"epoch": int(epoch), "step": int(step)}))

    @property
    def has_resume(self) -> bool:
        return (self.dir / "resume.json").exists()

    def resume_meta(self) -> dict:
        return json.loads((self.dir / "resume.json").read_text())

    def restore_resume(self, map_location=None) -> dict:
        return torch.load(self.dir / "resume.pt", map_location=map_location,
                          weights_only=True)
