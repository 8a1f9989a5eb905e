"""The end-to-end drivers of the port on the CPU at a tiny size:
full_workflow (fiode_tpu_torch/examples/full_workflow.py) restoring the run
directory of tests/test_torch_examples.py and training one epoch on its
data, each held to the JAX package's Certifier on the same weights and to
the fields of examples/demo_RESULTS.json; segway_workflow at 1 + 1
iterations, held to the JAX package's certify_segway on the controller it
trained and to the fields of examples/segway_RESULTS.json."""
import json

import numpy as np
import pytest
import torch

from fiode_tpu.control.certify_segway import certify_segway as jax_certify_segway
from fiode_tpu.experiment import build_model as jax_build_model
from fiode_tpu.utils.config import compose as jax_compose
from fiode_tpu.verify.certify import Certifier as JaxCertifier
from fiode_tpu_torch.bridge import load_npz, params_to_numpy, segway_to_numpy
from fiode_tpu_torch.control import load_segway
from fiode_tpu_torch.examples import full_workflow, segway_workflow
from fiode_tpu_torch.experiment import build_model
from fiode_tpu_torch.utils.config import compose
from test_torch_examples import (CFG_DIRS, EPS, JAX_CHUNK, N_TEST, REPO, T,
                                 TINY, WORST_TOL, _keys, one_torch_thread,  # noqa: F401
                                 tiny_run)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return tiny_run(tmp_path_factory.mktemp("workflow"))


def test_full_workflow_restored_matches_jax(tiny):
    # a restore carries the run's training time over from its RESULTS.json
    (tiny.run / "RESULTS.json").write_text(json.dumps({"train_seconds": 12.5}))
    got = full_workflow.main(tiny.args + [
        "--restore", "--epochs", "300", "--T", str(T), "--certify-eps", str(EPS),
        "--certify-images", str(N_TEST), "--attack-images", str(N_TEST),
        "++val_batch_size=6", *TINY, f"++data_root={tiny.data}"])
    assert got == json.loads((tiny.out / "RESULTS.json").read_text())
    assert _keys(REPO / "examples" / "demo_RESULTS.json") <= set(got)
    assert got["certify_scale_nominal"] is False  # the field after epoch 10
    assert got["restored_checkpoint"] and got["train_seconds"] == 12.5
    assert got["crown"]["certified_idx"] == np.nonzero(tiny.crown.certified)[0].tolist()
    assert got["crown"]["clean_acc"] == 1.0 and got["grid_cells"] == len(tiny.jcert.grid)
    for key, want in (("certified_idx", tiny.lips.certified),
                      ("larger_T_certified_idx", tiny.lips.larger_T_certified)):
        assert got["lipschitz"][key] == np.nonzero(want)[0].tolist()
    robust = set(got["autoattack"]["robust_idx"])
    assert got["autoattack"]["n_images"] == N_TEST
    assert got["consistent"] == (set(got["crown"]["certified_idx"]) <= robust)


def test_full_workflow_trains_and_matches_jax_on_its_weights(tiny, tmp_path):
    got = full_workflow.main([
        "--device", "cpu", "--out-dir", str(tmp_path), "--epochs", "1",
        "--h-sample", "4", "--T", str(T), "--certify-eps", str(EPS),
        "--certify-images", "3", "--attack-images", "3", "++batch_size=8",
        "++val_batch_size=3", *TINY, f"++data_root={tiny.data}"])
    assert _keys(REPO / "examples" / "demo_RESULTS.json") - {"restore_seconds"} <= set(got)
    assert 0.0 <= got["validation_error"] <= 1.0 and not got["synthetic_data"]
    assert got["certify_scale_nominal"] is True  # epoch 0 of cifar_train.yaml
    assert all(np.isfinite(json.loads(ln)["training_loss"])
               for ln in (tmp_path / "metrics.jsonl").read_text().splitlines()
               if "training_loss" in ln)
    # the JAX certifier on the trained weights
    cut = TINY + [f"++data_root={tiny.data}"]
    jcfg = jax_compose("cifar_train.yaml", cut, CFG_DIRS["train"])
    model = build_model(compose("cifar_train.yaml", cut, CFG_DIRS["train"]), "cpu")
    load_npz(model, tmp_path / "ckpt" / "last.npz")
    jcert = JaxCertifier(jax_build_model(jcfg), params_to_numpy(model), T=T,
                         eps_input=EPS, scale_nominal=True, chunk=JAX_CHUNK)
    for method in ("crown", "lipschitz"):
        want = jcert.certify(tiny.x[:3], tiny.y[:3], method=method)
        assert got[method]["certified_idx"] == np.nonzero(want.certified)[0].tolist()
        assert got[method]["clean_acc"] == pytest.approx(want.clean_acc)


def test_segway_workflow_matches_jax_on_its_controller(tmp_path):
    got = segway_workflow.main(["--device", "cpu", "--out", str(tmp_path),
                                "--iters", "1", "--r", "0.1"])
    assert set(got) == _keys(REPO / "examples" / "segway_RESULTS.json") - {
        "recertified_sound_interval"}  # written into the artifact by hand
    seg = load_segway(tmp_path / "segway.npz", "cpu")
    tree = segway_to_numpy(seg["ctrl"], seg["P"])
    want = jax_certify_segway(model=dict(tree, config={"hidden": 32}), r=0.1,
                              simulate_trajectories=False, verbose=False)
    assert (got["n_cells"], got["certified"]) == (want.n_cells, bool(want.certified))
    assert got["vdot_ub_max"] == pytest.approx(want.ub_max, abs=WORST_TOL)
    assert np.isfinite(got["best_barrier_loss"])
