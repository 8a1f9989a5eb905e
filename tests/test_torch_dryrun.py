"""The multi-chip dry run (fiode_tpu_torch/entry.py::dryrun_multichip, the
counterpart of __graft_entry__.dryrun_multichip) on two gloo ranks on the
CPU: every part runs, the certification mesh gives the unsharded
verdicts, worst values and refinement statistics, and the data-parallel
steps leave the parameters equal on both ranks (checked inside).  Asked
for CUDA on a machine without a card it raises before it starts a rank.
The example drivers and the dry run import nothing of JAX or of the JAX
package."""
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fiode_tpu_torch.entry import dryrun_multichip

REPO = Path(__file__).resolve().parents[1]
DRIVERS = sorted(p.stem for p in (REPO / "fiode_tpu_torch" / "examples").glob("*.py")
                 if not p.stem.startswith("_"))


def test_dryrun_on_two_gloo_ranks(capsys):
    report = dryrun_multichip(2, device="cpu")
    assert "dryrun_multichip(2) OK" in capsys.readouterr().out
    assert report["backend"] == "gloo" and report["n_devices"] == 2
    assert math.isfinite(report["tiny_loss"]) and math.isfinite(report["kwlarge_loss"])
    assert math.isfinite(report["crown_chunk_max"])
    assert set(report["launches"]) == {f"k{i}.launches" for i in range(1, 6)}
    mesh, base = report["certify"]["mesh"], report["certify"]["unsharded"]
    assert all(base["clean"])  # the labels are the model's predictions
    for key in ("clean", "certified", "refined", "refine_stats"):
        assert mesh[key] == base[key]
    np.testing.assert_array_equal(mesh["worst"], base["worst"])
    assert sum(s[2] for s in base["refine_stats"]) > 0  # BaB rounds ran
    assert report["apgd_rows"] == 2 and report["apgd_max_attempts"] < 4


def test_dryrun_on_cuda_without_a_card_raises(monkeypatch):
    started = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.multiprocessing, "start_processes",
                        lambda *a, **k: started.append(a))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun_multichip(2, device="cuda")
    with pytest.raises(ValueError, match="n_devices"):
        dryrun_multichip(0, device="cpu")
    assert not started


def _lazy_imports(path: Path) -> set:
    """The package modules a driver imports, at the top or inside main()."""
    import ast
    mods = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.level:
            base = "fiode_tpu_torch" if node.level == 2 else "fiode_tpu_torch.examples"
            mods.add(f"{base}.{node.module}" if node.module else base)
    return mods


def test_drivers_and_dry_run_import_without_jax():
    drivers = [f"fiode_tpu_torch.examples.{d}" for d in DRIVERS]
    lazy = set().union(*(_lazy_imports(REPO / "fiode_tpu_torch" / "examples" / f"{d}.py")
                         for d in DRIVERS))
    code = ("import importlib, sys\n"
            "for m in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'fiode_tpu'):\n"
            "    sys.modules[m] = None\n"
            f"for m in {sorted(lazy) + ['fiode_tpu_torch.entry']!r}:\n"
            "    importlib.import_module(m)\n"
            f"for m in {drivers!r}:\n"
            "    importlib.import_module(m)._parser().parse_args([])\n"
            "assert not any(k == 'jax' or k.startswith(('jax.', 'fiode_tpu.'))\n"
            "               for k, v in sys.modules.items() if v is not None)\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    assert len(DRIVERS) == 8 and "fiode_tpu_torch.verify.refine" in lazy
