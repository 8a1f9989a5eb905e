"""Port parity for the fused RHS (kernel K1's module): the plain version
against the JAX padded reference and against the K1 Pallas kernel in
interpret mode, the port's dynamics against flax, and the solve of the
configurations the fused path does not take (GroupSort dynamics, training
mode) against the JAX package's unfused solve.  The CUDA kernel is held against the plain version in
test_torch_kernels_cuda.py."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fiode_tpu.models.dynamics import SimplexDynamics as JaxDynamics
from fiode_tpu.models.ivp import NeuralODEClassifier as JaxClassifier
from fiode_tpu_torch.bridge import params_from_numpy
from fiode_tpu_torch.models.dynamics import SimplexDynamics
from fiode_tpu_torch.models.ivp import NeuralODEClassifier
from fiode_tpu_torch.ops.fused_rhs import (
    RhsParams,
    fused_rhs,
    pack_rhs_params,
)
from fiode_tpu_torch.utils.tracing import counters

# the JAX ops package re-exports a function named fused_rhs over the module
jf = importlib.import_module("fiode_tpu.ops.fused_rhs")

TOL = 1e-5
A1, S1, A2 = 100.0, 0.02, 20.0
# lower = -A1 (exp(S1 h) - 1): torch's and XLA's exp may differ by an ulp of
# 1 (2**-23), which A1 = 100 scales to 1.2e-5 on a lower-active output
TOL_RHS = 2 * A1 * 2.0**-23


def _inputs(n=10, mlp=32, B=37, seed=0):
    rng = np.random.default_rng(seed)
    W1 = 0.3 * rng.normal(size=(mlp, n))
    W2 = 0.3 * rng.normal(size=(mlp, mlp))
    W3 = 0.3 * rng.normal(size=(n, mlp))
    b2 = 0.1 * rng.normal(size=mlp)
    b3 = 0.1 * rng.normal(size=n)
    h = rng.uniform(size=(B, n))
    h = h / h.sum(-1, keepdims=True)
    xc = 0.5 * rng.normal(size=(B, mlp))
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return tuple(map(f32, (h, xc, W1, W2, W3, b2, b3)))


def _jax_padded(h, xc, W1, W2, W3, b2, b3):
    B, n = h.shape
    mlp = xc.shape[1]
    p = jf.pack_rhs_params(*(jnp.asarray(a) for a in (W1, W2, W3, b2, b3)))
    h_pad = jnp.zeros((B, jf.LANE)).at[:, :n].set(h)
    xc_pad = jnp.zeros((B, jf.LANE)).at[:, :mlp].set(xc)
    return h_pad, xc_pad, p


def _torch_plain(h, xc, W1, W2, W3, b2, b3, sn):
    p = pack_rhs_params(*(torch.from_numpy(a) for a in (W1, W2, W3, b2, b3)))
    return fused_rhs(torch.from_numpy(h), torch.from_numpy(xc), p, A1, S1, A2,
                     sn, 30).numpy()


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("scale_nominal", [False, True])
def test_plain_matches_jax_reference(scale_nominal, seed):
    arrs = _inputs(seed=seed)
    h_pad, xc_pad, p = _jax_padded(*arrs)
    n = arrs[0].shape[1]
    want = np.asarray(jf.rhs_reference(h_pad, xc_pad, p, n, A1, S1, A2,
                                       scale_nominal, 30))[:, :n]
    got = _torch_plain(*arrs, scale_nominal)
    np.testing.assert_allclose(got, want, atol=TOL_RHS)


@pytest.mark.parametrize("scale_nominal", [False, True])
def test_plain_matches_pallas_kernel_interpret(scale_nominal):
    arrs = _inputs(seed=3)
    h_pad, xc_pad, p = _jax_padded(*arrs)
    n = arrs[0].shape[1]
    fwd = jf._make_pallas_forward(n, A1, S1, A2, scale_nominal, 30, block=16,
                                  interpret=True)
    want = np.asarray(jax.jit(fwd)(h_pad, xc_pad, p))[:, :n]
    got = _torch_plain(*arrs, scale_nominal)
    np.testing.assert_allclose(got, want, atol=TOL_RHS)


def _dyn_pair(scale_nominal, activation="ReLU", mlp=32, n=10, x_dim=6):
    jdyn = JaxDynamics(n_hidden=n, mlp_size=mlp, x_dim=x_dim, dropout=0.0,
                       activation=activation, scale_nominal=scale_nominal)
    rng = np.random.default_rng(4)
    h = rng.uniform(size=(9, n))
    h = (h / h.sum(-1, keepdims=True)).astype(np.float32)
    x = rng.normal(size=(9, x_dim)).astype(np.float32)
    params = jdyn.init(jax.random.PRNGKey(0), jnp.asarray(h), jnp.asarray(x),
                       method=jdyn.eval_dot)["params"]
    tdyn = SimplexDynamics(n_hidden=n, mlp_size=mlp, x_dim=x_dim, dropout=0.0,
                           activation=activation, scale_nominal=scale_nominal)
    params_from_numpy(tdyn, jax.tree_util.tree_map(np.asarray, params))
    return jdyn, params, tdyn, h, x


@pytest.mark.parametrize("activation", ["ReLU", "GroupSort"])
@pytest.mark.parametrize("scale_nominal", [False, True])
def test_dynamics_eval_dot_matches_flax(scale_nominal, activation):
    jdyn, params, tdyn, h, x = _dyn_pair(scale_nominal, activation)
    want = np.asarray(jdyn.apply({"params": params}, jnp.asarray(h),
                                 jnp.asarray(x), method=jdyn.eval_dot))
    with torch.no_grad():
        got = tdyn.eval_dot(torch.from_numpy(h), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL)


@pytest.mark.parametrize("scale_nominal", [False, True])
def test_fused_setup_matches_eval_dot(scale_nominal):
    # the hoisted injection xc and densified weights give the same RHS
    _, _, tdyn, h, x = _dyn_pair(scale_nominal)
    model = NeuralODEClassifier(None, tdyn)
    with torch.no_grad():
        p, xc = model._fused_setup(torch.from_numpy(x))
        got = fused_rhs(torch.from_numpy(h), xc, p, A1, S1, A2, scale_nominal)
        want = tdyn.eval_dot(torch.from_numpy(h), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL)


def _classifier_pair(activation, dropout):
    """A backbone-free classifier in both packages, same parameters."""
    kw = dict(n_hidden=10, mlp_size=32, x_dim=4, dropout=dropout,
              activation=activation, alpha_1=A1, alpha_2=A2, sigma_1=S1)
    jmodel = JaxClassifier(backbone=None, dynamics=JaxDynamics(**kw),
                           n_classes=10)
    x = np.random.default_rng(5).normal(size=(7, 4)).astype(np.float32)
    params = jmodel.init(jax.random.PRNGKey(2), jnp.asarray(x))
    tmodel = NeuralODEClassifier(None, SimplexDynamics(**kw))
    params_from_numpy(tmodel, jax.tree_util.tree_map(np.asarray, params))
    return jmodel, params, tmodel.eval(), x


def _groupsort_solve_matches_jax(scale_nominal):
    jmodel, params, tmodel, x = _classifier_pair("GroupSort", 0.0)
    want = jax.jit(lambda p, x: jmodel.solve(
        p, x, scale_nominal=scale_nominal, fused=False))(params, jnp.asarray(x))
    before = counters().get("k1.launches", 0)
    with torch.no_grad():
        got = tmodel.solve(torch.from_numpy(x), scale_nominal=scale_nominal)
    assert counters().get("k1.launches", 0) == before
    np.testing.assert_allclose(got.ys[-1].numpy(), np.asarray(want.ys[-1]),
                               atol=1e-3)
    assert (got.nfe, got.n_accepted, got.n_rejected) == (
        int(want.nfe), int(want.n_accepted), int(want.n_rejected))
    # the gradient through the GroupSort solve is plain autograd
    xt = torch.from_numpy(x).requires_grad_()
    (dx,) = torch.autograd.grad(tmodel.solve(xt).ys[-1][:, 0].sum(), xt)
    assert torch.isfinite(dx).all() and dx.abs().sum() > 0


def test_fused_path_rejects_groupsort_dynamics():
    # GroupSort dynamics are not refused: the solve integrates eval_dot, as
    # the JAX package's unfused solve does (its fused kernel is ReLU-only)
    _groupsort_solve_matches_jax(False)


def test_groupsort_solve_with_scale_nominal_matches_jax():
    _groupsort_solve_matches_jax(True)


def _training_solve_matches_eval(activation):
    jmodel, params, tmodel, x = _classifier_pair(activation, 0.5)
    want = jax.jit(lambda p, x: jmodel.solve(p, x, fused=False))(
        params, jnp.asarray(x))
    with torch.no_grad():
        evaled = tmodel.eval().solve(torch.from_numpy(x))
        trained = tmodel.train().solve(torch.from_numpy(x))
    assert torch.equal(trained.ys, evaled.ys)
    assert trained.nfe == evaled.nfe
    np.testing.assert_allclose(trained.ys[-1].numpy(), np.asarray(want.ys[-1]),
                               atol=1e-3)
    assert trained.nfe == int(want.nfe)
    # dropout acts only when the caller asks for it
    h = torch.full((7, 10), 0.1)
    xt = torch.from_numpy(x)
    dyn = tmodel.dynamics
    assert torch.equal(dyn.raw(h, xt), dyn.raw(h, xt, train=False))
    assert not torch.equal(dyn.raw(h, xt, train=True), dyn.raw(h, xt))


def test_fused_path_rejects_training_dropout():
    # training mode is not refused: the solve never applies dropout, so a
    # training-mode solve equals the eval-mode one and the JAX solve
    _training_solve_matches_eval("ReLU")


def test_groupsort_training_solve_equals_eval_solve():
    _training_solve_matches_eval("GroupSort")


def test_pack_rhs_params_keeps_true_width():
    h, xc, W1, W2, W3, b2, b3 = _inputs(n=7, mlp=24, B=5)
    p = pack_rhs_params(*(torch.from_numpy(a).double()
                          for a in (W1, W2, W3, b2, b3)))
    assert isinstance(p, RhsParams)
    assert [tuple(t.shape) for t in p] == [(24, 7), (24, 24), (7, 24), (24,),
                                           (7,)]
    assert all(t.dtype == torch.float32 and t.is_contiguous() for t in p)
