"""The certify cell's inputs and window on the CPU, at a cut-down grid: the
trained checkpoint read name for name and shape for shape, and refused
before any window when it is not the file the configuration states; the
same test-set images for every seed, in the seed's order; a window of
whole sweeps of the grid; and the output check within its limits on the
checkpoint's weights, traced or not."""
import hashlib
import math

import numpy as np
import pytest
import torch

from perfbench import data, harness, run, weights
from perfbench.conftest import tiny_cell

NAME = "crown-certify-t40"
SEED = 2 ** 31 + 2222


def _gen():
    return harness.load_module("traffic", "crown_sweep")


def _npz(cell):
    return harness.ROOT / cell["config"]["checkpoint"]["path"]


def test_the_checkpoint_is_every_parameter_as_the_programs_loader_reads_it():
    from fiode_tpu_torch import bridge
    cell = tiny_cell(NAME)
    m = harness.program_model(cell["config"], "cpu")
    shapes = {k: tuple(p.shape) for k, p in m.named_parameters()}
    params = weights.checkpoint(_npz(cell), cell["config"]["checkpoint"]["sha256"],
                                shapes, "cpu")
    assert len(params) == len(shapes) == 33
    assert {k: tuple(v.shape) for k, v in params.items()} == shapes
    bridge.load_npz(m, _npz(cell))
    for k, p in m.named_parameters():
        assert torch.equal(p.detach(), params[k]), k


@pytest.mark.parametrize("fault", ["digest", "byte", "missing", "shape"])
def test_another_checkpoint_is_refused_before_any_window(tmp_path, fault):
    cell = tiny_cell(NAME)
    ck = cell["config"]["checkpoint"]
    raw = _npz(cell).read_bytes()
    path = tmp_path / "ckpt.npz"
    if fault == "digest":
        path.write_bytes(raw)
        ck["sha256"] = "0" * 64
    elif fault == "byte":
        path.write_bytes(raw[:-1] + bytes([raw[-1] ^ 1]))
    else:
        with np.load(_npz(cell)) as z:
            arrays = {k: z[k] for k in z.files}
        if fault == "missing":
            del arrays["dynamics/mlp_to_mlp/alpha"]
        else:
            arrays["dynamics/U_x/bias"] = arrays["dynamics/U_x/bias"][:-1]
        np.savez(path, **arrays)
        ck["sha256"] = hashlib.sha256(path.read_bytes()).hexdigest()
    ck["path"] = str(path)
    with pytest.raises(ValueError, match=str(path)):
        run.run(cell, SEED, 0.0, False, "cpu", harness.Clock())


def test_the_test_set_is_the_programs_synthetic_test_set():
    from fiode_tpu_torch.train.data import _synthetic
    ts = tiny_cell(NAME)["mix"]["test_set"]
    _, _, sx, sy = _synthetic("CIFAR10", n_train=4096, n_test=ts["size"],
                              seed=ts["seed"])
    xs, ys = data.synthetic_test_set(ts["seed"], ts["size"], 10, 3, 32,
                                     ts["noise"])
    assert np.array_equal(xs, sx) and np.array_equal(ys, sy)


def test_every_seed_sweeps_the_same_images_in_its_own_order():
    cell = tiny_cell(NAME)
    ts, I = cell["mix"]["test_set"], cell["mix"]["images"]
    xs, ys = data.synthetic_test_set(ts["seed"], ts["size"], 10, 3, 32,
                                     ts["noise"])
    want = xs[ts["first"]:ts["first"] + I]
    orders = set()
    for seed in (SEED, SEED + 1, SEED + 2, SEED):
        st = _gen().setup(cell, seed, "cpu")
        order = [int(np.flatnonzero((want == im).all(axis=(1, 2, 3)))[0])
                 for im in st.images.numpy()]
        assert sorted(order) == list(range(I))
        assert st.labels.tolist() == [int(ys[ts["first"] + k]) for k in order]
        orders.add((seed, tuple(order)))
    assert len({o for _, o in orders}) > 1 and len(orders) == 3


def _swept():
    cell = tiny_cell(NAME)
    gen = _gen()
    st = gen.setup(cell, SEED, "cpu")
    cfg = cell["config"]
    rows = len(st.cert.grid)
    n_blocks = math.ceil(rows / (cfg["chunk"] * cfg["superchunk"]))
    gen.window(st, 0)
    return gen, st, rows, n_blocks


def test_a_window_of_no_seconds_is_one_whole_sweep():
    gen, st, rows, n_blocks = _swept()
    w = st.window
    assert n_blocks > 2
    assert w["blocks"] == list(range(n_blocks))
    assert w["attempted"] == n_blocks and w["sweeps"] == 1
    assert w["items"] == rows * st.labels.shape[0]


def test_a_window_is_the_fewest_whole_sweeps_that_last_its_seconds():
    gen, st, rows, n_blocks = _swept()
    sweep_s = st.window["seconds"]
    gen.window(st, 2.5 * sweep_s)
    w = st.window
    assert w["sweeps"] >= 2 and w["seconds"] >= 2.5 * sweep_s
    assert w["blocks"] == list(range(n_blocks)) * w["sweeps"]
    assert w["items"] == w["sweeps"] * rows * st.labels.shape[0]


def test_the_check_on_the_checkpoint_is_within_its_limits():
    gen, st, rows, n_blocks = _swept()
    limits = st.mix["limits"]
    gen.release(st)
    checks = gen.check(st)
    assert set(checks) == set(limits)
    assert all(checks[k] <= limits[k] for k in limits), checks


def test_a_traced_run_is_whole_sweeps_and_profiles_the_grids_first_block():
    cell = tiny_cell(NAME)
    res = run.run(cell, SEED, 0.0, True, "cpu", harness.Clock())
    assert res["correct"], res["checks"]
    _, _, _, n_blocks = _swept()
    assert res["attempted"] == n_blocks and res["device"]["window_s"] > 0
    assert set(res["metrics"]) <= {m["name"] for m in cell["per_layer"]}
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
