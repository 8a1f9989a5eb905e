"""The port's command line (python -m fiode_tpu_torch, fiode_tpu_torch/cli.py)
over all nine commands at CLI_TINY shapes on the CPU (mirrors
tests/test_experiment_e2e.py::TestCliSurface and
tests/test_config_cli.py::test_build_and_tiny_train), held against the JAX
package where the answer is deterministic: the sample-grid arrays,
summarize-stream of a committed log, data-check of an empty directory and
segway-certify of the committed controller (the certify commands on the
committed checkpoint are held in tests/test_torch_cli_parity.py).  Also:
the grid file is written at exactly --out and read back by
++load_grid=True (it was once written as <out>.npy), the run directory's
parameters come from ckpt/best.npz, else ckpt/best_torch.npz, and the CLI
imports neither jax nor the JAX package."""
import importlib
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fiode_tpu.train.data import check_data_root as jcheck
from fiode_tpu.verify.certify import summarize_stream as jsummarize
from fiode_tpu.verify.grid import enumerate_decision_boundary as jgrid
from fiode_tpu_torch import cli
from fiode_tpu_torch.bridge import save_npz, segway_to_numpy
from fiode_tpu_torch.control.train_segway import load_segway
from fiode_tpu_torch.experiment import (
    _load_cfg_dataset, build_model, restore_model, run_certify_config)
from fiode_tpu_torch.utils.config import compose

# the package exports the function under its module's name
jseg = importlib.import_module("fiode_tpu.control.certify_segway")
REPO = Path(__file__).resolve().parents[1]
TRAIN_DIR = str(REPO / "configs" / "classification")
CERT_DIR = str(REPO / "configs" / "certify")
COMMANDS = ["train", "sample-grid", "certify-crown", "certify-lipschitz",
            "summarize-stream", "eval-autoattack", "data-check",
            "segway-train", "segway-certify"]
CLI_TINY = [
    "++batch_size=32",
    "++synthetic_size=256",
    "++val_batch_size=32",
    "++module.dynamics.mlp_size=32",
    "+module/init_fun/param_map@module.init_fun.param_map=TinyMLP",
    "++module.init_fun.param_map.out_dim=10",
]
SEGWAY_R = 0.05
SEGWAY_UB_TOL = 1e-4
CPU = ["--device", "cpu"]


def test_help_lists_the_nine_commands():
    out = subprocess.run([sys.executable, "-m", "fiode_tpu_torch", "--help"],
                         cwd=REPO, capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    listed = re.search(r"\{([a-z,-]+)\}", out.stdout).group(1).split(",")
    assert listed == COMMANDS
    # the restore order is in the certify commands' help
    help_text = subprocess.run(
        [sys.executable, "-m", "fiode_tpu_torch", "certify-crown", "--help"],
        cwd=REPO, capture_output=True, text=True, timeout=60).stdout
    assert "best.npz" in help_text and "best_torch.npz" in help_text
    assert "--device" in help_text


def test_full_command_surface(tmp_path, capsys):
    run_dir = tmp_path / "run"
    data_none = "++data_root=" + str(tmp_path / "none")

    cli.main(["train", *CPU, "--config-name", "mnist_train.yaml",
              "--config-dir", TRAIN_DIR, "--run-dir", str(run_dir),
              "--epochs", "1", "++module.h_sample_size=8", data_none, *CLI_TINY])
    for f in ("metrics.jsonl", "ckpt/best.npz", "ckpt/last.npz",
              "ckpt/resume.pt"):
        assert (run_dir / f).exists(), f

    # sample-grid: the JAX enumeration, at exactly --out
    grid_out = tmp_path / "grid.pt"
    cli.main(["sample-grid", *CPU, "--config-name", "mnist_certify.yaml",
              "--config-dir", CERT_DIR, "--out", str(grid_out), "++T=6"])
    assert grid_out.exists() and not Path(str(grid_out) + ".npy").exists()
    np.testing.assert_array_equal(np.load(grid_out), jgrid(10, 6))

    cert_args = ["--config-name", "mnist_certify.yaml", "--config-dir",
                 CERT_DIR, "--run-dir", str(run_dir), "--max-images", "2",
                 "++T=6", "++end_ind=2", data_none, *CLI_TINY]
    stream = tmp_path / "cert.jsonl"
    cli.main(["certify-crown", *CPU, "--stream-out", str(stream), *cert_args,
              "++refine_rounds=2", "++refine_box_budget=2000", "++chunk=64",
              "++load_grid=True", f"++grid_name={grid_out}"])
    raud = json.loads(Path(str(stream) + ".refine.json").read_text())
    assert raud["refine_rounds"] == 2 and raud["start_ind"] == 0
    assert all(0 <= s["image"] < 2 for s in raud["stats"])
    summary = json.loads(Path(str(stream) + ".json").read_text())
    assert summary["n_images"] == 2 and summary["cells_checked"] % 423 == 0
    cli.main(["certify-lipschitz", *CPU, *cert_args])

    aa = tmp_path / "aa.json"
    cli.main(["eval-autoattack", *CPU, "--config-name", "mnist_certify.yaml",
              "--config-dir", CERT_DIR, "--run-dir", str(run_dir),
              "--max-images", "8", "--attacks", "apgd-ce,square",
              "--out", str(aa), "++attack_n_iter=3",
              "++attack_square_queries=8", data_none, *CLI_TINY])
    art = json.loads(aa.read_text())
    jax_fields = {"attacks", "n_iter", "square_queries", "eps", "norm",
                  "t_max", "max_steps", "probe_attempts", "n_images",
                  "robust_acc", "robust_idx", "seconds", "images_per_sec"}
    assert jax_fields <= art.keys()
    assert art["attacks"] == ["apgd-ce", "square"] and art["norm"] == "2"
    assert art["n_iter"] == 3 and art["square_queries"] == 8
    cfg = compose("mnist_certify.yaml", [data_none, *CLI_TINY], CERT_DIR)
    model = restore_model(cfg, str(run_dir), "cpu")
    ds = _load_cfg_dataset(cfg)
    with torch.no_grad():
        pred = model.predict(torch.from_numpy(ds.test_x[:8])).argmax(-1).numpy()
    clean = set(np.nonzero(pred == ds.test_y[:8])[0].tolist())
    assert set(art["robust_idx"]) <= clean  # random starts differ by design
    out = capsys.readouterr().out
    assert "robust acc" in out and "certified" in out

    seg = tmp_path / "segway.npz"
    cli.main(["segway-train", *CPU, "--save", str(seg), "--iters", "3"])
    assert seg.exists() and load_segway(seg, "cpu")["P"].shape == (3, 3)


def test_summarize_stream_equals_the_jax_package(tmp_path, capsys):
    log = REPO / "run_data" / "certified_full" / "certify_stream_full_rep2.jsonl"
    cli.main(["summarize-stream", str(log), "--out", str(tmp_path / "s.json")])
    printed = json.loads(capsys.readouterr().out)
    want = jsummarize(str(log))
    assert printed == want
    assert json.loads((tmp_path / "s.json").read_text()) == want


def test_data_check_of_an_empty_directory(tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["data-check", "--data-root", str(tmp_path)])
    assert e.value.code == 1
    out = capsys.readouterr()
    report = json.loads(out.out)
    assert report == jcheck("CIFAR10", str(tmp_path))
    assert "NOT READY" in out.err


def _segway_line(text):
    m = re.search(r"\[certify_segway\] cells=(\d+) ub\.max=(\S+) "
                  r"exact\.max=(\S+) certified=(\w+)", text)
    return int(m.group(1)), float(m.group(2)), float(m.group(3)), m.group(4)


def test_segway_certify_equals_the_jax_package(tmp_path, capsys):
    path = REPO / "run_data" / "segway" / "segway_f32.npz"
    cli.main(["segway-certify", *CPU, "--model", str(path), "--r",
              str(SEGWAY_R)])
    got = _segway_line(capsys.readouterr().out)
    model = load_segway(path, "cpu")
    tree = dict(segway_to_numpy(model["ctrl"], model["P"]),
                config=model["config"])
    want = jseg.certify_segway(model=tree, r=SEGWAY_R,
                               simulate_trajectories=False)
    assert got[0] == want.n_cells and got[3] == str(want.certified)
    np.testing.assert_allclose(got[1], want.ub_max, atol=SEGWAY_UB_TOL)
    np.testing.assert_allclose(got[2], want.exact_vdot_max, atol=SEGWAY_UB_TOL)


def test_grid_file_round_trips_through_load_grid(tmp_path):
    """The repair of run_sample_grid: np.save appended .npy to grid.pt, so
    ++load_grid=True ++grid_name=grid.pt found no file."""
    from fiode_tpu_torch.experiment import run_sample_grid
    path = tmp_path / "grid.pt"
    grid = run_sample_grid(3, 12, out_path=str(path))
    assert sorted(p.name for p in tmp_path.iterdir()) == ["grid.pt"]
    cfg = compose("mnist_certify.yaml", [
        "+module/init_fun/param_map@module.init_fun.param_map=TinyMLP",
        "++module.init_fun.param_map.out_dim=10", "++dataset.N_CLASSES=3",
        "++module.dynamics.mlp_size=16", "++synthetic_size=64",
        f"++data_root={tmp_path / 'none'}", "++T=12", "++chunk=64",
        "++end_ind=2", "++load_grid=True", f"++grid_name={path}"], CERT_DIR)
    run = tmp_path / "run"
    (run / "ckpt").mkdir(parents=True)
    save_npz(build_model(cfg, "cpu"), run / "ckpt" / "best.npz")
    res = run_certify_config(cfg, "crown", str(run), device="cpu")
    assert res.cells_per_image == len(grid)
    # a grid that is not the config's T: the file, not an enumeration, is used
    other = tmp_path / "grid4.pt"
    run_sample_grid(3, 8, out_path=str(other))
    res4 = run_certify_config(dict(cfg, grid_name=str(other)), "crown",
                              str(run), device="cpu")
    assert res4.cells_per_image == len(np.load(other)) != len(grid)


def test_restore_order_and_refusals(tmp_path):
    cfg = compose("mnist_certify.yaml", [
        "+module/init_fun/param_map@module.init_fun.param_map=TinyMLP",
        "++module.init_fun.param_map.out_dim=10",
        "++module.dynamics.mlp_size=16"], CERT_DIR)
    run = tmp_path / "run"
    with pytest.raises(FileNotFoundError) as e:
        restore_model(cfg, str(run), "cpu")
    assert "best.npz" in str(e.value) and "best_torch.npz" in str(e.value)
    (run / "ckpt").mkdir(parents=True)
    a = build_model(cfg, "cpu")
    b = build_model(dict(cfg, seed=1), "cpu")
    save_npz(a, run / "ckpt" / "best_torch.npz")
    got = restore_model(cfg, str(run), "cpu")
    w = "dynamics.mlp_to_mlp.weight"
    assert not got.training
    assert torch.equal(dict(got.named_parameters())[w],
                       dict(a.named_parameters())[w])
    save_npz(b, run / "ckpt" / "best.npz")  # the port's own file comes first
    got = restore_model(cfg, str(run), "cpu")
    assert torch.equal(dict(got.named_parameters())[w],
                       dict(b.named_parameters())[w])
    with pytest.raises(ValueError, match="matmul_precision"):
        run_certify_config(dict(cfg, matmul_precision="bfloat16"), "crown",
                           str(run), device="cpu")


def test_cli_imports_without_jax():
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'fiode_tpu'):\n"
            "    sys.modules[m] = None\n"
            "import fiode_tpu_torch.cli as c, fiode_tpu_torch.experiment\n"
            "import fiode_tpu_torch.parallel.mesh, fiode_tpu_torch.parallel.multihost\n"
            "import fiode_tpu_torch.utils.plotting, fiode_tpu_torch.utils.debug\n"
            "c._parser().parse_args(['certify-crown', '--config-name', 'x',\n"
            "                        '--run-dir', 'r'])\n"
            "assert not any(k == 'jax' or k.startswith(('jax.', 'fiode_tpu.'))\n"
            "               for k, v in sys.modules.items() if v is not None)\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
