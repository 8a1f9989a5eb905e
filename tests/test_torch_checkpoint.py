"""The committed checkpoint run_data/certified_full/ckpt/best (KWLarge
GroupSort backbone, ReLU dynamics, scale_nominal off), restored by the JAX
package and bridged into the port, predicts what JAX predicts on the first
test images; the committed torch-readable copy of it
(ckpt/best_torch.npz) holds exactly the arrays the orbax restore gives and
round-trips through load_npz / save_npz; and importing the port (its
attacks, experiment, certification and data modules included) or what
chip_smoke.py imports pulls in neither jax, flax, orbax nor fiode_tpu."""
import ast
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fiode_tpu.experiment import _load_cfg_dataset, _restore_params, build_model
from fiode_tpu.utils.config import compose
from fiode_tpu_torch import params_from_numpy
from fiode_tpu_torch.bridge import load_npz, save_npz
from fiode_tpu_torch.entry import CIFAR_MU, CIFAR_STD
from fiode_tpu_torch.models.backbones import KWLargeBackbone
from fiode_tpu_torch.models.dynamics import SimplexDynamics
from fiode_tpu_torch.models.ivp import NeuralODEClassifier

REPO = Path(__file__).resolve().parents[1]
RUN_DIR = REPO / "run_data" / "certified_full"
N_IMAGES = 8
ENDPOINT_TOL = 1e-3


def _port_model(jmodel) -> NeuralODEClassifier:
    """The port's counterpart of the JAX model build_model made."""
    d = jmodel.dynamics
    dyn = SimplexDynamics(
        n_hidden=d.n_hidden, mlp_size=d.mlp_size, x_dim=d.x_dim,
        activation=d.activation, dropout=d.dropout, alpha_1=d.alpha_1,
        alpha_2=d.alpha_2, sigma_1=d.sigma_1, scale_nominal=d.scale_nominal,
        qp_iters=d.qp_iters,
    )
    b = jmodel.backbone
    backbone = KWLargeBackbone(out_dim=b.out_dim, act=b.act, mu=b.mu,
                               std=b.std, width=b.width)
    model = NeuralODEClassifier(
        backbone, dyn, t_max=jmodel.t_max,
        rtol=jmodel.rtol, atol=jmodel.atol, max_steps=jmodel.max_steps,
    )
    return model.eval()


@pytest.fixture(scope="module")
def restored():
    cfg = compose("cifar_certify", [], str(REPO / "configs" / "certify"))
    jmodel = build_model(cfg)
    params = _restore_params(cfg, jmodel, str(RUN_DIR))
    ds = _load_cfg_dataset(cfg)
    x = np.asarray(ds.test_x[:N_IMAGES], np.float32)
    y = np.asarray(ds.test_y[:N_IMAGES])
    return jmodel, params, x, y


def test_checkpoint_config_is_the_certified_flagship(restored):
    jmodel, _, _, _ = restored
    assert jmodel.dynamics.activation == "ReLU"
    assert not jmodel.dynamics.scale_nominal
    assert jmodel.dynamics.cayley
    # the port's only initial state, output map and solver
    assert (jmodel.h0_init, jmodel.output, jmodel.method) == (
        "uniform", "default", "dopri5")
    assert jmodel.backbone.act == "GroupSort"
    assert tuple(jmodel.backbone.mu) == CIFAR_MU
    assert tuple(jmodel.backbone.std) == CIFAR_STD


def test_checkpoint_predict_matches_jax(restored):
    jmodel, params, x, y = restored
    want = jax.jit(lambda p, x: jmodel.solve(p, x))(params, jnp.asarray(x))
    tmodel = params_from_numpy(_port_model(jmodel),
                               jax.tree_util.tree_map(np.asarray, params))
    with torch.no_grad():
        got = tmodel.solve(torch.from_numpy(x))
    want_p = np.asarray(want.ys[-1])
    got_p = got.ys[-1].numpy()
    np.testing.assert_allclose(got_p, want_p, atol=ENDPOINT_TOL)
    assert got.nfe == int(want.nfe)
    np.testing.assert_array_equal(got_p.argmax(-1), want_p.argmax(-1))
    # the certified checkpoint classifies these test images correctly
    np.testing.assert_array_equal(got_p.argmax(-1), y)


NPZ = RUN_DIR / "ckpt" / "best_torch.npz"


def _flat(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flat(val, prefix + (key,))
        else:
            yield "/".join(prefix + (key,)), np.asarray(val)


def test_npz_holds_exactly_the_orbax_arrays(restored):
    _, params, _, _ = restored
    want = dict(_flat(jax.tree_util.tree_map(np.asarray, params)))
    with np.load(NPZ, allow_pickle=False) as got:
        assert sorted(got.files) == sorted(want)
        for name, arr in want.items():
            assert got[name].dtype == arr.dtype == np.float32, name
            assert got[name].shape == arr.shape, name
            assert got[name].tobytes() == arr.tobytes(), name


def test_load_npz_round_trips_and_equals_the_bridge(restored, tmp_path):
    jmodel, params, x, _ = restored
    bridged = params_from_numpy(_port_model(jmodel),
                                jax.tree_util.tree_map(np.asarray, params))
    loaded = load_npz(_port_model(jmodel), NPZ)
    for (name, a), (_, b) in zip(loaded.state_dict().items(),
                                 bridged.state_dict().items(), strict=True):
        assert torch.equal(a, b), name
    out = tmp_path / "again.npz"
    save_npz(loaded, out)
    with np.load(NPZ) as want, np.load(out) as got:
        assert sorted(got.files) == sorted(want.files)
        for name in want.files:
            assert got[name].shape == want[name].shape, name
            assert got[name].tobytes() == want[name].tobytes(), name
    with pytest.raises(RuntimeError):  # every parameter must be matched
        load_npz(torch.nn.Linear(2, 2), NPZ)


def test_certify_model_loads_the_checkpoint(restored):
    from fiode_tpu_torch.entry import certify_model
    _, _, x, y = restored
    model = certify_model(device="cpu", checkpoint=NPZ)
    assert not model.training
    with torch.no_grad():
        pred = model.predict(torch.from_numpy(x)).argmax(-1).numpy()
    np.testing.assert_array_equal(pred, y)


def _assert_imports_leave_jax_out(imports: str):
    code = (
        f"import sys\n{imports}\n"
        "bad = [m for m in ('jax', 'flax', 'optax', 'orbax', 'fiode_tpu', 'yaml') "
        "if m in sys.modules]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_import_leaves_jax_out():
    _assert_imports_leave_jax_out(
        "import fiode_tpu_torch, fiode_tpu_torch.ops.fused_rhs, "
        "fiode_tpu_torch.ops.fused_cayley_conv, fiode_tpu_torch.attacks, "
        "fiode_tpu_torch.experiment, fiode_tpu_torch.verify.certify, "
        "fiode_tpu_torch.verify.grid, fiode_tpu_torch.verify.crown, "
        "fiode_tpu_torch.verify.ibp_qp, fiode_tpu_torch.train.data, "
        "fiode_tpu_torch.train.trainer, fiode_tpu_torch.train.lyapunov, "
        "fiode_tpu_torch.train.samplers, fiode_tpu_torch.train.schedulers, "
        "fiode_tpu_torch.train.lips, fiode_tpu_torch.ops.power_iteration, "
        "fiode_tpu_torch.utils.config, fiode_tpu_torch.utils.checkpoint, "
        "fiode_tpu_torch.utils.logging, fiode_tpu_torch.models.backbones, "
        "fiode_tpu_torch.control, fiode_tpu_torch.verify.interval, "
        "fiode_tpu_torch.ode.adjoint, fiode_tpu_torch.ode.tableaus, "
        "fiode_tpu_torch.models.legacy_dynamics")


def test_chip_smoke_imports_leave_jax_out():
    """Every import statement of chip_smoke.py, at module level or inside a
    function, executed in a fresh interpreter."""
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    lines = sorted({ast.unparse(node) for node in ast.walk(tree)
                    if isinstance(node, (ast.Import, ast.ImportFrom))
                    and getattr(node, "module", "") != "__future__"})
    assert any("fiode_tpu_torch.verify.certify" in ln for ln in lines)
    _assert_imports_leave_jax_out("\n".join(lines))
