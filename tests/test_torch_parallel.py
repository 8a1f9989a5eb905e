"""Certification on a device mesh (fiode_tpu_torch/parallel/mesh.py, the
Certifier's and refinement's mesh rules), mirroring
tests/test_parallel_certify.py: the sweep, the exact witness and every
refinement pass split over Mesh([cpu] * 4, ("cell",)) and a 2 x 2
("img", "cell") mesh give the unsharded verdicts, worst values, violated
counts and rounds, and run_certify_config takes mesh_shape as [2, 2] and
as 4."""
from pathlib import Path

import numpy as np
import pytest
import torch

from fiode_tpu_torch.bridge import save_npz
from fiode_tpu_torch.experiment import build_model, run_certify_config
from fiode_tpu_torch.models.backbones import make_backbone
from fiode_tpu_torch.models.dynamics import SimplexDynamics
from fiode_tpu_torch.models.ivp import NeuralODEClassifier
from fiode_tpu_torch.parallel.mesh import Mesh, make_mesh, make_mesh2d
from fiode_tpu_torch.utils.config import compose
from fiode_tpu_torch.verify.certify import Certifier, shard_devices
from fiode_tpu_torch.verify.refine import hybrid_base_sweep, refine_uncertified
from fiode_tpu_torch.verify.refine_lips import refine_lips_uncertified
from test_torch_refine import one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
MESHES = {
    "cell4": Mesh([CPU] * 4, ("cell",)),
    "img2xcell2": Mesh([[CPU, CPU], [CPU, CPU]], ("img", "cell")),
}
REFINE = dict(chunk=64, superchunk=4, max_rounds=4, frontier_cap=4096,
              box_budget=10000)


def _model(act):
    g = torch.Generator().manual_seed(0)
    dyn = SimplexDynamics(n_hidden=3, mlp_size=16, x_dim=6, dropout=0.0,
                          activation=act, generator=g)
    bb = make_backbone("TinyMLP", out_dim=6, act="GroupSort", mu=(0.5,),
                       std=(0.25,), in_channels=1, img_size=8, generator=g)
    model = NeuralODEClassifier(bb, dyn, n_classes=3, generator=g).eval()
    x = torch.rand(6, 1, 8, 8, generator=g)
    with torch.no_grad():
        y = model.predict(x).argmax(-1).numpy()
    y[5] = (y[5] + 1) % 3  # one image not clean
    return model, x, y


@pytest.fixture(scope="module", params=["ReLU", "GroupSort"])
def setup(request):
    return _model(request.param)


def _cert(model, mesh=None):
    return Certifier(model, T=8, eps_input=0.01, chunk=64, mesh=mesh)


@pytest.mark.parametrize("mesh", MESHES)
def test_sweep_and_witness_on_a_mesh_equal_unsharded(setup, mesh):
    model, x, y = setup
    base, shd = _cert(model), _cert(model, MESHES[mesh])
    for method in ("crown", "lipschitz"):
        r0 = base.certify(x, y, method=method, early_exit=False)
        r1 = shd.certify(x, y, method=method, early_exit=False)
        np.testing.assert_array_equal(r0.clean, r1.clean)
        np.testing.assert_array_equal(r0.certified, r1.certified)
        np.testing.assert_array_equal(r0.worst, r1.worst)
        assert r0.cells_checked == r1.cells_checked
        if method == "lipschitz":
            np.testing.assert_array_equal(r0.larger_T_certified,
                                          r1.larger_T_certified)
            np.testing.assert_array_equal(r0.worst_larger_T, r1.worst_larger_T)
    for a, b in zip(base.exact_witness(x, y), shd.exact_witness(x, y)):
        np.testing.assert_array_equal(a, b)


def test_refinement_on_a_mesh_equals_unsharded(setup):
    model, x, y = setup
    base, shd = _cert(model), _cert(model, MESHES["img2xcell2"])
    res = base.certify(x, y, "crown", early_exit=False)

    def key(stats):
        return [(s.image, s.base_violated, s.rounds, s.boxes_evaluated,
                 s.certified, s.gave_up) for s in stats]

    c0, s0 = refine_uncertified(base, x, y, res.certified, clean=res.clean, **REFINE)
    c1, s1 = refine_uncertified(shd, x, y, res.certified, clean=res.clean, **REFINE)
    np.testing.assert_array_equal(c0, c1)
    assert key(s0) == key(s1) and sum(s.rounds for s in s0) > 0
    h0, h1 = hybrid_base_sweep(base, x, y), hybrid_base_sweep(shd, x, y)
    assert [(s.worst, s.n_violated, s.certified) for s in h0] == [
        (s.worst, s.n_violated, s.certified) for s in h1]
    rl = base.certify(x, y, "lipschitz", early_exit=False)
    l0 = refine_lips_uncertified(base, x, y, rl.certified, clean=rl.clean,
                                 exact_ok=rl.larger_T_certified, **REFINE)
    l1 = refine_lips_uncertified(shd, x, y, rl.certified, clean=rl.clean,
                                 exact_ok=rl.larger_T_certified, **REFINE)
    np.testing.assert_array_equal(l0[0], l1[0])
    assert key(l0[1]) == key(l1[1])


def test_placement_rules():
    d = np.array([f"cuda:{i}" for i in range(6)], dtype=object)
    m1 = Mesh(list(d[:4]), ("anything",))
    assert [str(v) for v in shard_devices(m1, CPU).reshape(-1)] == [
        "cuda:0", "cuda:1", "cuda:2", "cuda:3"]
    assert shard_devices(m1, CPU).shape == (1, 4)  # 1-D: cells only
    m2 = Mesh(d.reshape(2, 3), ("img", "cell"))
    assert shard_devices(m2, CPU).shape == (2, 3)
    m3 = Mesh(d.reshape(3, 2), ("cell", "img"))  # axes in the other order
    g3 = shard_devices(m3, CPU)
    assert g3.shape == (2, 3) and str(g3[1, 0]) == "cuda:1"
    m4 = Mesh(d.reshape(2, 3), ("data", "cell"))  # no "img": first row
    assert [str(v) for v in shard_devices(m4, CPU).reshape(-1)] == [
        "cuda:0", "cuda:1", "cuda:2"]
    assert shard_devices(None, CPU).shape == (1, 1)
    assert make_mesh2d(2, 2, device_type="cpu").shape == {"img": 2, "cell": 2}
    assert make_mesh(4, axis="cell", device_type="cpu").size == 4
    if torch.cuda.device_count() < 8:
        with pytest.raises(RuntimeError, match="found"):
            make_mesh(8)  # never truncated to the devices there are
    with pytest.raises(ValueError):
        Mesh([CPU] * 4, ("img", "cell"))


def test_run_certify_config_takes_mesh_shape(tmp_path):
    cfg = compose("mnist_certify.yaml", [
        "+module/init_fun/param_map@module.init_fun.param_map=TinyMLP",
        "++module.init_fun.param_map.out_dim=10",
        "++module.dynamics.mlp_size=16", "++synthetic_size=64",
        f"++data_root={tmp_path / 'none'}", "++T=5", "++eps=0.01",
        "++chunk=64", "++start_ind=1", "++end_ind=5"],
        str(REPO / "configs" / "certify"))
    run = tmp_path / "run"
    (run / "ckpt").mkdir(parents=True)
    save_npz(build_model(cfg, "cpu"), run / "ckpt" / "best.npz")
    results = {}
    for shape in (None, [2, 2], 4):
        c = dict(cfg) if shape is None else dict(cfg, mesh_shape=shape)
        results[str(shape)] = run_certify_config(c, "crown", str(run),
                                                 device="cpu")
    r0 = results["None"]
    assert r0.clean.shape == (4,)
    for r in results.values():
        np.testing.assert_array_equal(r.clean, r0.clean)
        np.testing.assert_array_equal(r.certified, r0.certified)
        np.testing.assert_array_equal(r.worst, r0.worst)
