"""Port parity for the legacy conv dynamics
(``fiode_tpu_torch/models/legacy_dynamics.py``): ConvBlockDynamics with the
basic and the bottleneck block, each block alone, ResNetOutput, and an rk4
solve of the conv ODE, against the JAX package with its parameters carried
over by bridge (flax HWIO conv kernels, GroupNorm scales, Dense kernels)
(CPU, float32)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fiode_tpu.models import legacy_dynamics as jl
from fiode_tpu.ode.integrate import odeint as jax_odeint
from fiode_tpu_torch import params_from_numpy
from fiode_tpu_torch.bridge import params_to_numpy
from fiode_tpu_torch.models import legacy_dynamics as tl
from fiode_tpu_torch.ode.integrate import odeint

TOL = 1e-5
C = 8  # features; the state is (B, C, 8, 8)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(2, C, 8, 8)).astype(np.float32)
    x = rng.uniform(0.0, 1.0, (2, 3, 8, 8)).astype(np.float32)
    return h, x


@pytest.fixture(scope="module", params=["basic", "bottleneck"])
def dyn_pair(request):
    h, x = _inputs()
    jdyn = jl.ConvBlockDynamics(features=C, block=request.param)
    variables = jdyn.init(jax.random.PRNGKey(1), jnp.asarray(h),
                          jnp.asarray(x))
    tdyn = tl.ConvBlockDynamics(features=C, block=request.param,
                                in_channels=3)
    params_from_numpy(tdyn, _np(variables["params"]))
    return jdyn, variables, tdyn, h, x


def test_rhs_and_state_init_match_jax(dyn_pair):
    jdyn, variables, tdyn, h, x = dyn_pair
    want = jax.jit(jdyn.apply)(variables, jnp.asarray(h), jnp.asarray(x))
    want_h0 = jax.jit(lambda v, x: jdyn.apply(v, x, method=jdyn.state_init))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        got = tdyn(torch.from_numpy(h), torch.from_numpy(x))
        got_h0 = tdyn.state_init(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)
    np.testing.assert_allclose(got_h0.numpy(), np.asarray(want_h0), atol=TOL)


def test_parameters_cross_back(dyn_pair):
    _, variables, tdyn, _, _ = dyn_pair
    back = params_to_numpy(tdyn)
    want = dict(jax.tree_util.tree_leaves_with_path(variables["params"]))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert set(map(str, want)) == set(map(str, got))
    for path, w in want.items():
        np.testing.assert_array_equal(got[path], np.asarray(w))


def test_rk4_solve_matches_jax(dyn_pair):
    jdyn, variables, tdyn, _, x = dyn_pair
    ts = [0.0, 0.25, 0.5]
    h0 = jdyn.apply(variables, jnp.asarray(x), method=jdyn.state_init)
    want = jax.jit(lambda h0: jax_odeint(
        lambda t, h, a: jdyn.apply(variables, h, jnp.asarray(x)), h0,
        jnp.asarray(ts), method="rk4", step_size=0.1))(h0)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        got = odeint(lambda t, h: tdyn(h, xt), tdyn.state_init(xt), ts,
                     method="rk4", step_size=0.1)
    assert got.nfe == int(want.nfe) == 4 * 2 * 3
    assert torch.isfinite(got.ys).all()
    np.testing.assert_allclose(got.ys.numpy(), np.asarray(want.ys), atol=TOL)


@pytest.mark.parametrize("block", ["DynBasicBlock", "DynBottleneck"])
def test_block_alone_matches_jax(block):
    h, _ = _inputs(1)
    jb = getattr(jl, block)(features=C)
    variables = jb.init(jax.random.PRNGKey(2), jnp.asarray(h))
    tb = getattr(tl, block)(C)
    params_from_numpy(tb, _np(variables["params"]))
    with torch.no_grad():
        got = tb(torch.from_numpy(h))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jax.jit(jb.apply)(variables, h)),
                               atol=TOL)


def test_group_norm_takes_the_flax_epsilon():
    # a near-constant plane: the epsilon decides the normalised scale
    h = np.full((1, C, 4, 4), 0.5, np.float32)
    h[0, :, 0, 0] += 1e-3
    jb = jl.DynBasicBlock(features=C)
    variables = jb.init(jax.random.PRNGKey(3), jnp.asarray(h))
    tb = tl.DynBasicBlock(C)
    params_from_numpy(tb, _np(variables["params"]))
    assert tb.GroupNorm_0.eps == 1e-6
    with torch.no_grad():
        got = tb(torch.from_numpy(h))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jax.jit(jb.apply)(variables, h)),
                               atol=1e-4)


def test_resnet_output_matches_jax():
    h, _ = _inputs(2)
    jout = jl.ResNetOutput(n_classes=10)
    variables = jout.init(jax.random.PRNGKey(4), jnp.asarray(h))
    tout = tl.ResNetOutput(C, n_classes=10)
    params_from_numpy(tout, _np(variables["params"]))
    with torch.no_grad():
        got = tout(torch.from_numpy(h))
    assert tuple(got.shape) == (2, 10)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jax.jit(jout.apply)(variables, h)),
                               atol=TOL)
    np.testing.assert_array_equal(params_to_numpy(tout)["Dense_0"]["kernel"],
                                  np.asarray(variables["params"]["Dense_0"]["kernel"]))
