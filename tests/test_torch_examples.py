"""The example drivers of the port (fiode_tpu_torch/examples/) on the CPU
at a tiny size, against the JAX package's library functions on the same
parameters and images (full_workflow and segway_workflow:
tests/test_torch_examples_workflow.py).

The model is cifar_certify.yaml cut to a TinyMLP backbone (6 features)
and 4-class ReLU dynamics with mlp 16 (APGD-T in full_workflow needs 4
classes), on CIFAR files written here: six test images labelled as the
model predicts them.  JAX initialises the weights
and the port reads them from the run directory's ckpt/best.npz.  At T = 8
and eps 0.01 CROWN certifies one image, the Lipschitz
sweep none with its slack and four without it, so every driver has work:
the hybrid sweep, the exact witnesses, both refinements, alpha-CROWN and
the alpha probe are held to the JAX package (verdicts, violated counts,
rounds and boxes exactly, worst values within WORST_TOL) and their JSON to
the field names of the JAX drivers' committed artifacts.
examples/refine_accounting.py and
examples/inclusion_check.py run unchanged on what the drivers wrote, and a
driver run with its default --out-dir leaves `git status` as it was."""
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fiode_tpu.experiment import build_model as jax_build_model
from fiode_tpu.utils.config import compose as jax_compose
from fiode_tpu.verify import refine as jrefine
from fiode_tpu.verify import refine_lips as jrefine_lips
from fiode_tpu.verify.certify import Certifier as JaxCertifier
from fiode_tpu_torch import params_from_numpy
from fiode_tpu_torch.bridge import save_npz
from fiode_tpu_torch.examples import (alpha_crown_demo, alpha_probe,
                                      full_workflow, hybrid_sweep,
                                      refine_lips_workflow, refine_workflow,
                                      refute_witnesses, segway_workflow)
from fiode_tpu_torch.experiment import build_model
from fiode_tpu_torch.utils.config import compose

REPO = Path(__file__).resolve().parents[1]
CFG_DIRS = {"certify": str(REPO / "configs" / "certify"),
            "train": str(REPO / "configs" / "classification")}
ARTIFACTS = REPO / "run_data" / "certified_full"
EPS, N_TEST = 0.01, 6
# the model, cut to size (in the certify and in the train config)
TINY = ["+module/init_fun/param_map@module.init_fun.param_map=TinyMLP",
        "++module.init_fun.param_map.out_dim=6", "++module.dynamics.mlp_size=16",
        "++module.dynamics.n_hidden=4", "++module.dynamics.x_dim=6",
        "++module.dynamics.dropout=0.0", "++dataset.N_CLASSES=4"]
T, SEED = 8, 2
BLOCKS = ["--chunk", "32", "--superchunk", "2"]
BUDGETS = dict(chunk=32, superchunk=2, max_rounds=2)
# two float32 frameworks' CROWN products and bisections on the same cells
# (tests/test_torch_refine.py's hybrid tolerance)
WORST_TOL = 1e-4
# the JAX certifiers' chunk: their sweep pads every block to it, and a
# verdict does not depend on it
JAX_CHUNK = 8


def _keys(path):
    art = json.loads(Path(path).read_text())
    return set(art[0] if isinstance(art, list) else art)


def _cifar_bin(path, x, y):
    """CIFAR-10's binary format: a label byte, then 3072 pixel bytes."""
    path.write_bytes(np.concatenate([y[:, None].astype(np.uint8),
                                     x.reshape(len(x), -1)], 1).tobytes())


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    # thousands of tiny CPU ops per run: one intra-op thread is faster, and
    # does not oversubscribe the cores that parallel test workers share
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_run(root: Path):
    """The run directory (ckpt/best.npz, the sweep summaries) and its data
    under ``root``, and the JAX package's certifier and sweeps on the same
    weights: CROWN certifies one of the six images, the Lipschitz sweep
    none with its slack and four without it."""
    data, run, out = root / "data", root / "run", root / "out"
    over = TINY + [f"++data_root={data}", f"++T={T}", f"++eps={EPS}"]
    jcfg = jax_compose("cifar_certify.yaml", over, CFG_DIRS["certify"])
    jmodel = jax_build_model(jcfg)
    params = jmodel.init(jax.random.PRNGKey(SEED), jnp.zeros((1, 3, 32, 32)))
    tmodel = build_model(compose("cifar_certify.yaml", over, CFG_DIRS["certify"]),
                         "cpu").eval()
    params_from_numpy(tmodel, jax.tree_util.tree_map(np.asarray, params))
    (run / "ckpt").mkdir(parents=True)
    save_npz(tmodel, run / "ckpt" / "best.npz")

    rng = np.random.default_rng(SEED)
    pix = rng.integers(0, 256, (20 + N_TEST, 3, 32, 32)).astype(np.uint8)
    x = pix[20:].astype(np.float32) / 255.0
    with torch.no_grad():  # every test image clean
        y = tmodel.predict(torch.from_numpy(x)).argmax(-1).numpy()
    (data / "cifar-10-batches-bin").mkdir(parents=True)
    for i in range(5):
        _cifar_bin(data / "cifar-10-batches-bin" / f"data_batch_{i + 1}.bin",
                   pix[4 * i:4 * i + 4], rng.integers(0, 4, 4))
    _cifar_bin(data / "cifar-10-batches-bin" / "test_batch.bin", pix[20:], y)

    jcert = JaxCertifier(jmodel, params, T=T, eps_input=EPS, chunk=JAX_CHUNK)
    crown = jcert.certify(x, y, method="crown", early_exit=False)
    lips = jcert.certify(x, y, method="lipschitz", early_exit=False)
    assert crown.clean.all() and 0 < crown.certified.sum()
    assert not lips.certified.any() and 0 < lips.larger_T_certified.sum() < N_TEST
    idx = lambda m: np.nonzero(m)[0].tolist()  # noqa: E731
    (run / "crown.summary.json").write_text(json.dumps({
        "n_images": N_TEST, "index_min": 0, "index_max": N_TEST - 1,
        "certified_idx": idx(crown.certified), "clean_idx": idx(crown.clean)}))
    (run / "lips.jsonl.json").write_text(json.dumps({
        "n_images": N_TEST, "start_ind": 0, "method": "lipschitz",
        "certified_idx": idx(lips.certified), "clean_idx": idx(lips.clean),
        "larger_T_certified_idx": idx(lips.larger_T_certified)}))
    return types.SimpleNamespace(
        run=run, out=out, data=data, over=over, x=x, y=y,
        jmodel=jmodel, params=params, jcert=jcert, crown=crown, lips=lips,
        args=["--device", "cpu", "--run-dir", str(run), "--out-dir", str(out)])


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return tiny_run(tmp_path_factory.mktemp("examples"))


def _stats(recs, fields):
    return [tuple(r[f] for f in fields) for r in recs]


REFINE_FIELDS = ("image", "base_violated", "rounds", "boxes_evaluated",
                 "certified", "gave_up", "pre_alpha_violated")


def test_hybrid_sweep_matches_jax(tiny):
    got = hybrid_sweep.main(tiny.args + ["--summary", "crown.summary.json",
                                         "--end", str(N_TEST), *BLOCKS, *tiny.over])
    assert set(got) == _keys(ARTIFACTS / "hybrid_sweep.json")
    skip = tiny.crown.certified  # CROWN-certified: dominated
    want = jrefine.hybrid_base_sweep(tiny.jcert, tiny.x, tiny.y, chunk=32,
                                     superchunk=2, skip=skip)
    assert got["swept"] == [s.image for s in want] == np.nonzero(~skip)[0].tolist()
    for g, w in zip(got["stats"], want):
        assert (g["n_violated"], g["clean"], g["certified"]) == (
            w.n_violated, w.clean, w.certified)
        assert g["worst"] == pytest.approx(w.worst, abs=WORST_TOL)
    assert set(got["stats"][0]) == set(json.loads(
        (ARTIFACTS / "hybrid_sweep.json").read_text())["stats"][0])
    # a rerun resumes every image from the sidecar
    again = hybrid_sweep.main(tiny.args + ["--summary", "crown.summary.json",
                                           "--end", str(N_TEST), *BLOCKS, *tiny.over])
    assert again["stats"] == got["stats"]


def test_refute_witnesses_matches_jax(tiny):
    got = refute_witnesses.main(tiny.args + [
        "--images", ",".join(map(str, range(N_TEST))), *tiny.over])
    assert set(got) == _keys(ARTIFACTS / "exact_witnesses.json")
    vals, idxs, clean = tiny.jcert.exact_witness(tiny.x, tiny.y)
    for rec, v, i, c in zip(got["witnesses"], vals, idxs, clean):
        assert (rec["witness_cell_idx"], rec["clean"]) == (int(i), bool(c))
        assert rec["witness_value"] == pytest.approx(float(v), abs=WORST_TOL)
        assert rec["verdict"] == ("refuted" if v > 0 else "tractable")
    assert set(got["witnesses"][0]) == set(json.loads(
        (ARTIFACTS / "exact_witnesses.json").read_text())["witnesses"][0])


def test_refine_workflow_matches_jax(tiny):
    got = refine_workflow.main(tiny.args + [
        "--summary", "crown.summary.json", "--end", str(N_TEST), "--rounds", "2",
        *BLOCKS, *tiny.over])
    assert set(got) == _keys(ARTIFACTS / "refine_full_pass7.json")
    assert got["matmul_precision"] == "float32"
    want_cert, want = jrefine.refine_uncertified(
        tiny.jcert, tiny.x, tiny.y, tiny.crown.certified, clean=tiny.crown.clean,
        **BUDGETS)
    assert _stats(got["stats"], REFINE_FIELDS) == [
        tuple(getattr(s, f) for f in REFINE_FIELDS) for s in want]
    assert got["certified_idx"] == np.nonzero(want_cert)[0].tolist()
    assert sum(s["rounds"] for s in got["stats"]) > 0
    # resume: every verdict streamed under these budgets is kept
    stream = [json.loads(ln) for ln in
              (tiny.out / "refine_full_stream.jsonl").read_text().splitlines()]
    assert [r["image"] for r in stream] == [s.image for s in want]
    assert all("device_cap" not in r["params"] for r in stream)
    again = refine_workflow.main(tiny.args + [
        "--summary", "crown.summary.json", "--end", str(N_TEST), "--rounds", "2",
        *BLOCKS, *tiny.over])
    assert again["stats"] == got["stats"]


def test_refine_lips_workflow_matches_jax(tiny):
    got = refine_lips_workflow.main(tiny.args + [
        "--summary", "lips.jsonl.json", "--end", str(N_TEST), "--rounds", "2",
        *BLOCKS, *tiny.over])
    assert set(got) == _keys(ARTIFACTS / "refine_lips_probe.json")
    want_cert, want = jrefine_lips.refine_lips_uncertified(
        tiny.jcert, tiny.x, tiny.y, tiny.lips.certified,
        exact_ok=tiny.lips.larger_T_certified, clean=tiny.lips.clean, **BUDGETS)
    assert _stats(got["stats"], REFINE_FIELDS) == [
        tuple(getattr(s, f) for f in REFINE_FIELDS) for s in want]
    assert got["certified_idx"] == np.nonzero(want_cert)[0].tolist()
    assert {s["gave_up"] for s in got["stats"]} >= {"exact_violation"}


def test_alpha_crown_demo_matches_jax(tiny):
    got = alpha_crown_demo.main(tiny.args + [
        "--start", "0", "--end", str(N_TEST), "--T", str(T), "--alpha-iters", "2",
        "--alpha-objective", "width",
        *TINY, f"++data_root={tiny.data}"])
    # the JAX driver at HEAD also writes alpha_objective, which the
    # committed artifact predates
    assert _keys(ARTIFACTS / "ALPHA_CROWN.json") <= set(got)
    assert set(got) - _keys(ARTIFACTS / "ALPHA_CROWN.json") == {"alpha_objective"}
    plain = JaxCertifier(tiny.jmodel, tiny.params, T=T, eps_input=36 / 255,
                         chunk=JAX_CHUNK)
    res = plain.certify(tiny.x, tiny.y, method="crown", early_exit=False)
    assert got["plain_certified"] == int(res.certified.sum())
    fail = np.nonzero(res.clean & ~res.certified)[0]
    assert got["failing_idx"] == fail.tolist() and len(fail)
    alpha = JaxCertifier(tiny.jmodel, tiny.params, T=T, eps_input=36 / 255,
                         chunk=JAX_CHUNK, alpha_iters=2, alpha_objective="width")
    want = alpha.certify(tiny.x[fail], tiny.y[fail], method="crown", early_exit=False)
    assert got["alpha_recovered"] == int(want.certified.sum())


def test_alpha_probe_matches_jax(tiny):
    got = alpha_probe.main(tiny.args + ["--images", "0,2,3", "--sample", "3",
                                        *tiny.over])
    assert [set(r) for r in got] == [_keys(ARTIFACTS / "alpha_probe.json")] * 3
    want = jrefine.hybrid_base_sweep(tiny.jcert, tiny.x[[0, 2, 3]], tiny.y[[0, 2, 3]],
                                     lips_box=False, chunk=32, superchunk=2)
    assert [r["plain_violated"] for r in got] == [s.n_violated for s in want]
    assert all(0.0 <= r["alpha2_closed_frac"] <= 1.0 for r in got)


def test_accounting_and_inclusion_fold_the_drivers_artifacts(tiny):
    # the refinement and the audit the accounting folds, and an attack
    # artifact of the port's command line
    from fiode_tpu_torch.cli import main as cli_main

    refine_workflow.main(tiny.args + [
        "--summary", "crown.summary.json", "--end", str(N_TEST), "--rounds", "2",
        *BLOCKS, *tiny.over])
    refute_witnesses.main(tiny.args + ["--images", "3,5", *tiny.over])
    cli_main(["eval-autoattack", "--device", "cpu", "--config-name",
              "cifar_certify.yaml", "--run-dir", str(tiny.run), "--attacks",
              "apgd-ce", "--out", str(tiny.out / "autoattack_tiny.json"),
              *tiny.over, "++attack_n_iter=2", "++module.t_max=0.1"])
    summary = str(tiny.run / "crown.summary.json")
    for script, extra in (("refine_accounting.py", []),
                          ("inclusion_check.py", ["--attack", "autoattack_tiny.json"])):
        proc = subprocess.run(
            [sys.executable, str(REPO / "examples" / script), "--run-dir",
             str(tiny.out), "--summary", summary, *extra],
            capture_output=True, text=True, timeout=60)
        assert proc.returncode in (0, 2), proc.stderr  # 2: inclusion violated
    acct = json.loads((tiny.out / "refine_accounting.json").read_text())
    refined = json.loads((tiny.out / "refine_full.json").read_text())
    assert acct["certified"] == refined["certified"]
    assert acct["base_certified"] == int(tiny.crown.certified.sum())
    audit = json.loads((tiny.out / "exact_witnesses.json").read_text())
    assert acct["refuted_exact_witness"] == sorted(
        set(audit["refuted"]) & set(acct["open_images"]))
    inc = json.loads((tiny.out / "inclusion_tiny.json").read_text())
    assert inc["n_images"] == N_TEST and inc["certified"] == refined["certified"]


def test_default_out_dir_leaves_the_tree_clean(tiny, monkeypatch):
    def status():
        return subprocess.run(["git", "status", "--porcelain"], cwd=REPO,
                              capture_output=True, text=True, check=True).stdout

    drivers = (full_workflow, segway_workflow, hybrid_sweep, refute_witnesses,
               refine_workflow, refine_lips_workflow, alpha_crown_demo, alpha_probe)
    for d in drivers:
        default = d._parser().parse_args([]).out_dir
        assert default == f"run_data/torch/{d.__name__.rsplit('.', 1)[1]}"
        assert subprocess.run(["git", "check-ignore", "-q", f"{default}/x.json"],
                              cwd=REPO).returncode == 0, default
    before = status()
    monkeypatch.chdir(REPO)
    name = f"witnesses_{os.getpid()}.json"
    out_dir = REPO / "run_data" / "torch" / "refute_witnesses"
    made = not out_dir.exists()
    try:
        refute_witnesses.main(["--device", "cpu", "--run-dir", str(tiny.run),
                               "--images", "0", "--out", name, *tiny.over])
        assert (out_dir / name).exists()
        assert status() == before
    finally:
        (out_dir / name).unlink(missing_ok=True)
        if made:
            out_dir.rmdir()
            if not any(out_dir.parent.iterdir()):
                out_dir.parent.rmdir()


# the JAX drivers' flags the port leaves behind (each driver's docstring)
LEFT_BEHIND = {"full_workflow": {"--steps-per-call"},
               "refine_workflow": {"--device-cap"}}


@pytest.mark.parametrize("driver", [
    full_workflow, segway_workflow, hybrid_sweep, refute_witnesses,
    refine_workflow, refine_lips_workflow, alpha_crown_demo, alpha_probe],
    ids=lambda d: d.__name__.rsplit(".", 1)[1])
def test_driver_takes_its_jax_twins_flags(driver):
    import re
    name = driver.__name__.rsplit(".", 1)[1]
    twin = set(re.findall(r'add_argument\(\s*"(--[\w-]+)"',
                          (REPO / "examples" / f"{name}.py").read_text()))
    flags = {o for a in driver._parser()._actions for o in a.option_strings}
    dropped = LEFT_BEHIND.get(name, set())
    assert twin - dropped <= flags and not dropped & flags
    assert all(f in driver.__doc__ for f in dropped)
    assert {"--device", "--out-dir"} <= flags


def test_a_cuda_driver_without_a_card_raises(tiny, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        refute_witnesses.main(["--device", "cuda", "--run-dir", str(tiny.run),
                               "--out-dir", str(tiny.out), "--images", "0",
                               *tiny.over])
