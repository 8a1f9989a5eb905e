"""Gradients through the solve: d(CE)/dx and d(CE)/dparams through the
port's differentiable dopri5 solve equal ``jax.grad`` through the JAX
package's fused ``scan``-mode solve, on the small TinyMLP classifier of
tests/test_fused_rhs.py (scale_nominal off and on) and on the committed
certified checkpoint at the attack protocol's t_max = 0.1, max_steps = 8 (CPU, float32)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_fused_rhs import make_model
from test_torch_checkpoint import RUN_DIR

from fiode_tpu.attacks.apgd import ce_loss as jax_ce
from fiode_tpu.experiment import _load_cfg_dataset, _restore_params, build_model
from fiode_tpu.utils.config import compose
from fiode_tpu_torch import params_from_numpy
from fiode_tpu_torch.entry import certify_model
from fiode_tpu_torch.attacks.apgd import ce_loss
from fiode_tpu_torch.bridge import _flatten, _port_name
from fiode_tpu_torch.models.backbones import TinyMLPBackbone
from fiode_tpu_torch.models.dynamics import SimplexDynamics
from fiode_tpu_torch.models.ivp import NeuralODEClassifier

# the gradient tolerance of the JAX package's fused-vs-unfused scan test
# (tests/test_fused_rhs.py::test_fused_scan_gradients)
GRAD_TOL = 5e-3


def _jax_grads(jmodel, params, x, y):
    def loss(p, x):
        sol = jmodel.solve(p, x, mode="scan", fused=True)
        return jnp.sum(jax_ce(sol.ys[-1], y))

    return jax.jit(jax.grad(loss, argnums=(0, 1)))(params, jnp.asarray(x))


def _port_grads(tmodel, x, y):
    xt = torch.from_numpy(np.array(x, np.float32)).requires_grad_()
    sol = tmodel.solve(xt)
    loss = ce_loss(sol.ys[-1], torch.from_numpy(np.asarray(y))).sum()
    loss.backward()
    return sol, xt.grad.numpy()


def _tiny_pair(scale_nominal):
    jmodel, params, x = make_model(scale_nominal=scale_nominal)
    jmodel = dataclasses.replace(jmodel, max_steps=16)
    d = jmodel.dynamics
    tmodel = NeuralODEClassifier(
        TinyMLPBackbone(64, out_dim=10, hidden=16, mu=(0.5,), std=(0.25,)),
        SimplexDynamics(n_hidden=d.n_hidden, mlp_size=d.mlp_size,
                        x_dim=d.x_dim, dropout=0.0, alpha_1=d.alpha_1,
                        alpha_2=d.alpha_2, sigma_1=d.sigma_1,
                        scale_nominal=scale_nominal),
        max_steps=jmodel.max_steps)
    params_from_numpy(tmodel, jax.tree_util.tree_map(np.asarray, params))
    return jmodel, params, tmodel, np.asarray(x)


@pytest.fixture(scope="module")
def tiny_pair():
    return _tiny_pair(False)


def _assert_tiny_grads_match_jax(pair):
    jmodel, params, tmodel, x = pair
    y = np.array([0, 1, 2, 3, 4, 5])
    gp, gx = _jax_grads(jmodel, params, x, jnp.asarray(y))
    sol, got_x = _port_grads(tmodel, x, y)
    assert sol.attempts < tmodel.max_steps
    np.testing.assert_allclose(got_x, np.asarray(gx), atol=GRAD_TOL)
    want = {_port_name(path): np.asarray(v) for path, v in _flatten(gp)}
    named = dict(tmodel.named_parameters())
    assert set(want) == set(named)
    for name, w in want.items():
        g = named[name].grad
        assert g is not None, name
        np.testing.assert_allclose(g.numpy(), w, atol=GRAD_TOL, err_msg=name)


def test_tiny_solve_input_and_param_grads_match_jax(tiny_pair):
    _assert_tiny_grads_match_jax(tiny_pair)


def test_tiny_scale_nominal_solve_grads_match_jax():
    # the squashed dynamics of the flagship: on CUDA this gradient is K2's
    # scale_nominal branch, whose plain version autograd follows here
    pair = _tiny_pair(True)
    assert pair[2].dynamics.scale_nominal
    _assert_tiny_grads_match_jax(pair)


def test_tiny_solve_grad_nfe_matches_the_forward(tiny_pair):
    # the differentiable solve takes the same steps as the no-grad one
    _, _, tmodel, x = tiny_pair
    with torch.no_grad():
        plain = tmodel.solve(torch.from_numpy(np.array(x)))
    sol, _ = _port_grads(tmodel, x, np.zeros(6, int))
    assert (sol.nfe, sol.attempts) == (plain.nfe, plain.attempts)
    np.testing.assert_array_equal(sol.ys.detach().numpy(), plain.ys.numpy())


def test_checkpoint_input_grad_matches_jax():
    cfg = compose("cifar_certify", [], str(RUN_DIR.parents[1] / "configs"
                                           / "certify"))
    jmodel = dataclasses.replace(build_model(cfg), t_max=0.1, max_steps=8)
    params = _restore_params(cfg, jmodel, str(RUN_DIR))
    ds = _load_cfg_dataset(cfg)
    x = np.asarray(ds.test_x[:4], np.float32)
    y = np.asarray(ds.test_y[:4])
    _, gx = _jax_grads(jmodel, params, x, jnp.asarray(y))
    # the port's constructor of this configuration loads the checkpoint as is
    tmodel = params_from_numpy(
        certify_model(t_max=0.1, max_steps=8, device="cpu"),
        jax.tree_util.tree_map(np.asarray, params))
    d, td = jmodel.dynamics, tmodel.dynamics
    assert (td.mlp_size, td.activation, td.scale_nominal) == (
        d.mlp_size, d.activation, d.scale_nominal)
    assert (td.alpha_1, td.sigma_1, td.alpha_2) == (d.alpha_1, d.sigma_1,
                                                    d.alpha_2)
    assert (tmodel.rtol, tmodel.atol) == (jmodel.rtol, jmodel.atol)
    tmodel.requires_grad_(False)
    sol, got_x = _port_grads(tmodel, x, y)
    assert sol.attempts < tmodel.max_steps
    gx = np.asarray(gx)
    assert np.abs(gx).max() > 0
    np.testing.assert_allclose(got_x, gx, atol=GRAD_TOL)
