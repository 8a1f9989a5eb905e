"""The committed checkpoint run_data/certified_full/ckpt/best (KWLarge
GroupSort backbone, ReLU dynamics, scale_nominal off), restored by the JAX
package and bridged into the port, predicts what JAX predicts on the first
test images; and importing the port, its attacks and its experiment
module included, pulls in neither jax, flax nor fiode_tpu."""
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


def test_import_leaves_jax_out():
    code = (
        "import sys, fiode_tpu_torch, fiode_tpu_torch.ops.fused_rhs, "
        "fiode_tpu_torch.ops.fused_cayley_conv, fiode_tpu_torch.attacks, "
        "fiode_tpu_torch.experiment\n"
        "bad = [m for m in ('jax', 'flax', 'orbax', 'fiode_tpu') "
        "if m in sys.modules]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
