"""certify-crown (with branch-and-bound refinement) and certify-lipschitz of
the port's command line against the JAX package's, on the committed
checkpoint run_data/certified_full (the port reads ckpt/best_torch.npz, the
JAX package the orbax checkpoint) and the synthetic test images 0-3 at
T = 6: equal clean and certified sets, equal stream lines and summaries
apart from their timing fields, and equal refinement audits."""
import json
from pathlib import Path

import pytest

from fiode_tpu.cli import main as jax_main
from fiode_tpu_torch.cli import main as torch_main

REPO = Path(__file__).resolve().parents[1]
RUN = str(REPO / "run_data" / "certified_full")
TIMING = {"seconds", "cells_per_sec"}


def _drop_timing(rec):
    return {k: v for k, v in rec.items() if k not in TIMING}


def _lines(path):
    return [_drop_timing(json.loads(ln))
            for ln in Path(path).read_text().splitlines() if ln.strip()]


@pytest.mark.parametrize("method,refine", [("crown", True),
                                           ("lipschitz", False)])
def test_certify_commands_equal_the_jax_package(tmp_path, method, refine):
    args = ["--config-name", "cifar_certify.yaml", "--config-dir",
            str(REPO / "configs" / "certify"), "--run-dir", RUN, "++T=6",
            "++start_ind=0", "++end_ind=4", "++chunk=64",
            f"++data_root={tmp_path / 'none'}"]
    if refine:
        args += ["++refine_rounds=2", "++refine_box_budget=20000"]
    logs = {}
    for name, main, extra in (("jax", jax_main, []),
                              ("torch", torch_main, ["--device", "cpu"])):
        logs[name] = str(tmp_path / f"{name}.jsonl")
        main([f"certify-{method}", *extra, "--stream-out", logs[name], *args])
    assert _lines(logs["jax"]) == _lines(logs["torch"])
    summaries = [_drop_timing(json.loads(Path(p + ".json").read_text()))
                 for p in (logs["jax"], logs["torch"])]
    assert summaries[0] == summaries[1]
    assert summaries[1]["clean_idx"] == [0, 1, 2, 3]
    if refine:
        audits = [json.loads(Path(p + ".refine.json").read_text())
                  for p in (logs["jax"], logs["torch"])]
        for a in audits:
            for s in a["stats"]:
                s.pop("seconds")
        assert audits[0] == audits[1]
        assert [s["image"] for s in audits[1]["stats"]] == [0, 1, 2, 3]
