"""Port parity for the continuous adjoint (``fiode_tpu_torch/ode/adjoint.py``
and ``NeuralODEClassifier.solve(use_adjoint=True)``): the analytic
gradients of tests/test_ode.py's adjoint cases, several output times, and
the tiny classifier's input and parameter gradients against the JAX
package's ``solve(use_adjoint=True)``, ReLU (K1 + K2's plain versions on
the CPU) and GroupSort dynamics, scale_nominal off and on (CPU, float32)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fiode_tpu.attacks.apgd import ce_loss as jax_ce
from fiode_tpu.models.backbones import TinyMLPBackbone as JaxTinyMLP
from fiode_tpu.models.dynamics import SimplexDynamics as JaxDynamics
from fiode_tpu.models.ivp import NeuralODEClassifier as JaxClassifier
from fiode_tpu.ode.adjoint import odeint_adjoint as jax_odeint_adjoint
from fiode_tpu_torch import params_from_numpy
from fiode_tpu_torch.attacks.apgd import ce_loss
from fiode_tpu_torch.bridge import _flatten, _port_name
from fiode_tpu_torch.models.backbones import TinyMLPBackbone
from fiode_tpu_torch.models.dynamics import SimplexDynamics
from fiode_tpu_torch.models.ivp import NeuralODEClassifier
from fiode_tpu_torch.ode.adjoint import odeint_adjoint

# the gradient tolerance of the JAX package's fused-vs-unfused scan test
# (tests/test_fused_rhs.py::test_fused_scan_gradients)
GRAD_TOL = 5e-3


def f_param(t, y, params):
    return -params[0] * y


def test_adjoint_gradient_analytic():
    # d/da y(1) for y' = -a y, y(0) = 1 is -exp(-a)
    a = torch.tensor(0.7, requires_grad=True)
    ys = odeint_adjoint(f_param, torch.ones(()), [0.0, 1.0], (a,),
                        rtol=1e-6, atol=1e-6)
    ys[-1].backward()
    np.testing.assert_allclose(a.grad.item(), -np.exp(-0.7), atol=1e-3)
    want = jax.jit(jax.grad(lambda a: jax_odeint_adjoint(
        lambda t, y, args: -args["a"] * y, jnp.ones(()),
        jnp.asarray([0.0, 1.0]), {"a": a}, "dopri5", 1e-6, 1e-6)[-1]))(
        jnp.asarray(0.7))
    np.testing.assert_allclose(a.grad.item(), float(want), atol=1e-5)


def test_adjoint_gradient_wrt_y0():
    y0 = torch.ones(2, requires_grad=True)
    stats = {}
    ys = odeint_adjoint(lambda t, y, p: -y, y0, [0.0, 1.0], rtol=1e-6,
                        atol=1e-6, stats=stats)
    ys[-1].sum().backward()
    np.testing.assert_allclose(y0.grad.numpy(), np.exp(-1.0) * np.ones(2),
                               atol=1e-3)
    assert stats["forward"].nfe > 0 and stats["backward_nfe"] > 0
    assert stats["backward_accepted"] > 0


def test_adjoint_gradient_through_several_output_times():
    # L = y(0.5) + y(1.2) for y' = -a y: dL/da = -0.5 e^-0.5a - 1.2 e^-1.2a,
    # dL/dy0 = e^-0.5a + e^-1.2a
    a = torch.tensor(0.7, requires_grad=True)
    y0 = torch.tensor(1.0, requires_grad=True)
    ys = odeint_adjoint(f_param, y0, [0.0, 0.5, 1.2], (a,), rtol=1e-6,
                        atol=1e-6)
    (ys[1] + ys[2]).backward()
    e1, e2 = np.exp(-0.35), np.exp(-0.84)
    np.testing.assert_allclose(a.grad.item(), -0.5 * e1 - 1.2 * e2, atol=1e-3)
    np.testing.assert_allclose(y0.grad.item(), e1 + e2, atol=1e-3)


def test_adjoint_seminorm_leaves_the_parameter_adjoint_out_of_step_control():
    a = torch.tensor(0.7, requires_grad=True)
    nfe = {}
    for seminorm in (True, False):
        stats = {}
        ys = odeint_adjoint(lambda t, y, p: -p[0] * torch.sin(y) * 40.0,
                            torch.ones(3), [0.0, 1.0], (a,), rtol=1e-5,
                            atol=1e-5, seminorm=seminorm, stats=stats)
        ys[-1].sum().backward()
        nfe[seminorm] = stats["backward_nfe"]
    assert nfe[True] != nfe[False]


def _pair(activation, scale_nominal):
    """The tiny classifier (TinyMLP, n = 10, mlp = 32) in both packages, the
    JAX parameters carried over by bridge."""
    kw = dict(n_hidden=10, mlp_size=32, x_dim=10, dropout=0.0,
              alpha_1=100.0, alpha_2=20.0, sigma_1=0.02,
              scale_nominal=scale_nominal, activation=activation)
    jmodel = JaxClassifier(
        backbone=JaxTinyMLP(out_dim=10, hidden=16, mu=(0.5,), std=(0.25,)),
        dynamics=JaxDynamics(cayley=True, **kw), n_classes=10, max_steps=32)
    x = np.random.default_rng(0).uniform(0.0, 1.0, (6, 1, 8, 8))
    x = x.astype(np.float32)
    params = jmodel.init(jax.random.PRNGKey(1), jnp.asarray(x))
    tmodel = NeuralODEClassifier(
        TinyMLPBackbone(64, out_dim=10, hidden=16, mu=(0.5,), std=(0.25,)),
        SimplexDynamics(**kw), max_steps=32)
    params_from_numpy(tmodel, jax.tree_util.tree_map(np.asarray, params))
    return jmodel, params, tmodel, x


@pytest.mark.parametrize("scale_nominal", [False, True])
@pytest.mark.parametrize("activation", ["ReLU", "GroupSort"])
def test_classifier_adjoint_gradients_match_jax(activation, scale_nominal):
    jmodel, params, tmodel, x = _pair(activation, scale_nominal)
    y = np.arange(x.shape[0]) % 10

    def jax_loss(p, x):
        ys = jmodel.solve(p, x, use_adjoint=True).ys
        return jnp.sum(jax_ce(ys[-1], jnp.asarray(y)))

    gp, gx = jax.jit(jax.grad(jax_loss, argnums=(0, 1)))(params,
                                                         jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    stats = {}
    sol = tmodel.solve(xt, use_adjoint=True, adjoint_stats=stats)
    ce_loss(sol.ys[-1], torch.from_numpy(y)).sum().backward()
    assert stats["backward_nfe"] > 0 and sol.nfe == stats["forward"].nfe
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=GRAD_TOL)
    want = {_port_name(path): np.asarray(v) for path, v in _flatten(gp)}
    named = dict(tmodel.named_parameters())
    assert set(want) == set(named)
    for name, w in want.items():
        assert named[name].grad is not None, name
        np.testing.assert_allclose(named[name].grad.numpy(), w, atol=GRAD_TOL,
                                   err_msg=name)


def test_frozen_weights_give_the_same_input_gradient():
    # with the weights frozen only xc's adjoint is integrated (K2 without
    # weight gradients on CUDA); the seminorm keeps the step control, so the
    # input gradient is the one taken with every parameter's adjoint
    _, _, tmodel, x = _pair("ReLU", True)
    y = torch.from_numpy(np.arange(x.shape[0]) % 10)
    grads, nfe = [], []
    for frozen in (False, True):
        tmodel.requires_grad_(not frozen)
        xt = torch.from_numpy(x).requires_grad_()
        stats = {}
        sol = tmodel.solve(xt, use_adjoint=True, adjoint_stats=stats)
        ce_loss(sol.ys[-1], y).sum().backward()
        grads.append(xt.grad.numpy())
        nfe.append(stats["backward_nfe"])
    assert nfe[0] == nfe[1]
    np.testing.assert_allclose(grads[1], grads[0], atol=1e-6)
