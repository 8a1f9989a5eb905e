"""Port parity for the classifier's options and the layers' twins: the
``zeros`` start, the ``first_n`` and ``linear`` outputs and a per-call
``method`` against the JAX NeuralODEClassifier; ``build_model`` against the
JAX one for a val_ode_solver, init_fun and output other than the defaults;
the cached Cayley twins (``cache_cayley_params``, the ``_test`` backbones)
against the JAX package's cached twin and against the uncached model; an
unfilled twin's NaN; ``inter``; ``use_bias=False``; and the ``dft1``
transform against ``dft`` (CPU, float32)."""
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fiode_tpu.experiment import build_model as jax_build_model
from fiode_tpu.models.backbones import KWLargeBackbone as JaxKWLarge
from fiode_tpu.models.backbones import TinyMLPBackbone as JaxTinyMLP
from fiode_tpu.models.dynamics import SimplexDynamics as JaxDynamics
from fiode_tpu.models.ivp import NeuralODEClassifier as JaxClassifier
from fiode_tpu.models.layers import CayleyConv as JaxCayleyConv
from fiode_tpu.models.layers import CayleyLinear as JaxCayleyLinear
from fiode_tpu.models.layers import cache_cayley_params as jax_cache
from fiode_tpu.ops.cayley import apply_freq_matrices as jax_apply
from fiode_tpu.utils.config import compose as jax_compose
from fiode_tpu_torch import params_from_numpy
from fiode_tpu_torch.bridge import params_to_numpy
from fiode_tpu_torch.experiment import build_model
from fiode_tpu_torch.models.backbones import (KWLargeBackbone, TinyMLPBackbone,
                                              make_backbone)
from fiode_tpu_torch.models.dynamics import SimplexDynamics
from fiode_tpu_torch.models.ivp import NeuralODEClassifier
from fiode_tpu_torch.models.layers import (CayleyConv, CayleyLinear,
                                           cache_cayley_params)
from fiode_tpu_torch.ops.cayley import apply_freq_matrices, cayley_conv_kernel
from fiode_tpu_torch.utils.config import compose

REPO = Path(__file__).resolve().parents[1]
# the simplex RHS's tolerance against JAX (tests/test_torch_fused_rhs.py)
RHS_TOL = 2.4e-5
FEAT_TOL = 1e-4  # a KWLarge forward, the two packages' float32 transforms
DYN = dict(n_hidden=10, mlp_size=16, x_dim=10, dropout=0.0, alpha_1=100.0,
           alpha_2=20.0, sigma_1=0.02, scale_nominal=True)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _x(shape, seed=0):
    return np.random.default_rng(seed).uniform(0.0, 1.0, shape).astype(
        np.float32)


def _classifier_pair(**opts):
    jmodel = JaxClassifier(
        backbone=JaxTinyMLP(out_dim=10, hidden=16, mu=(0.5,), std=(0.25,)),
        dynamics=JaxDynamics(cayley=True, **DYN), max_steps=32, **opts)
    x = _x((4, 1, 8, 8))
    params = jmodel.init(jax.random.PRNGKey(2), jnp.asarray(x))
    tmodel = NeuralODEClassifier(
        TinyMLPBackbone(64, out_dim=10, hidden=16, mu=(0.5,), std=(0.25,)),
        SimplexDynamics(**DYN), max_steps=32, **opts)
    params_from_numpy(tmodel, _np(params))
    return jmodel, params, tmodel, x


@pytest.mark.parametrize("opts", [
    dict(n_classes=10, h0_init="zeros"),
    dict(n_classes=4, output="first_n"),
    dict(n_classes=3, output="linear"),
    dict(n_classes=10, method="bosh3"),
], ids=["zeros", "first_n", "linear", "method"])
def test_classifier_option_matches_jax(opts):
    jmodel, params, tmodel, x = _classifier_pair(**opts)
    want = jax.jit(jmodel.predict)(params, jnp.asarray(x))
    sol_j = jax.jit(jmodel.solve)(params, jnp.asarray(x))
    with torch.no_grad():
        got = tmodel.predict(torch.from_numpy(x))
        sol = tmodel.solve(torch.from_numpy(x))
    assert tuple(got.shape) == (4, opts["n_classes"])
    assert (sol.nfe, sol.n_accepted, sol.n_rejected) == (
        int(sol_j.nfe), int(sol_j.n_accepted), int(sol_j.n_rejected))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=RHS_TOL)
    if "output" in opts and opts["output"] == "linear":
        # the readout's kernel crosses as output.weight, and back
        np.testing.assert_array_equal(params_to_numpy(tmodel)["output"]["kernel"],
                                      np.asarray(params["output"]["kernel"]))


def test_per_call_solver_options_match_jax():
    jmodel, params, tmodel, x = _classifier_pair(n_classes=10)
    kw = dict(method="adaptive_heun", rtol=1e-4, atol=1e-4)
    want = jax.jit(lambda p, x: jmodel.solve(p, x, **kw))(params,
                                                          jnp.asarray(x))
    traj_j = jax.jit(lambda p, x: jmodel.trajectory(p, x, 5, method="rk4"))
    with torch.no_grad():
        got = tmodel.solve(torch.from_numpy(x), **kw)
        # a fixed-grid method needs a step; the JAX trajectory has none
        with pytest.raises(ValueError, match="needs step_size"):
            traj_j(params, jnp.asarray(x))
        traj = tmodel.trajectory(torch.from_numpy(x), 5, method="rk4",
                                 step_size=0.05)
    assert (got.nfe, got.n_accepted, got.n_rejected) == (
        int(want.nfe), int(want.n_accepted), int(want.n_rejected))
    np.testing.assert_allclose(got.ys.numpy(), np.asarray(want.ys),
                               atol=RHS_TOL)
    assert tuple(traj.shape) == (5, 4, 10)
    assert torch.isfinite(traj).all()


def _cfg_pair(overrides):
    """cifar_train.yaml cut to TinyMLP and mlp 16.  (mnist_train.yaml's
    alpha_2 = 50 with the squash is ill-conditioned at this init: the port's
    float32 and float64 solves differ by 6e-2 there, so it cannot hold two
    float32 packages to 2.4e-5.)"""
    base = ["++module.dynamics.mlp_size=16", "++module.dynamics.dropout=0.0",
            "+module/init_fun/param_map@module.init_fun.param_map=TinyMLP",
            "++module.init_fun.param_map.out_dim=10", "++seed=3"]
    args = ("cifar_train.yaml", base + overrides,
            str(REPO / "configs" / "classification"))
    return jax_compose(*args), compose(*args)


@pytest.mark.parametrize("overrides", [
    ["++module.val_ode_solver=bosh3"],
    ["+module/init_fun@module.init_fun=DefaultInitFun",
     "+module/init_fun/param_map@module.init_fun.param_map=TinyMLP",
     "++module.init_fun.param_map.out_dim=10"],
    ["+module/output@module.output=FirstNOutput"],
    ["++module.output.target=linear"],
    ["++module.output.target=no_such_output"],
], ids=["bosh3", "DefaultInitFun", "first_n", "linear", "unknown_output"])
def test_build_model_matches_jax(overrides):
    jcfg, tcfg = _cfg_pair(overrides)
    jmodel = jax_build_model(jcfg)
    tmodel = build_model(tcfg, device="cpu")
    assert (tmodel.method, tmodel.h0_init, tmodel.output_kind) == (
        jmodel.method, jmodel.h0_init, jmodel.output)
    x = _x((4, 3, 32, 32), 1)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params_from_numpy(tmodel, _np(params))
    want = jax.jit(jmodel.predict)(params, jnp.asarray(x))
    with torch.no_grad():
        got = tmodel.predict(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=RHS_TOL)


def test_build_model_with_a_fixed_solver_needs_a_step_as_in_jax():
    jcfg, tcfg = _cfg_pair(["++module.val_ode_solver=rk4"])
    jmodel, tmodel = jax_build_model(jcfg), build_model(tcfg, device="cpu")
    x = _x((2, 3, 32, 32))
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x))
    with pytest.raises(ValueError, match="needs step_size"):
        jmodel.predict(params, jnp.asarray(x))
    with pytest.raises(ValueError, match="needs step_size"), torch.no_grad():
        tmodel.predict(torch.from_numpy(x))
    with torch.no_grad():
        assert torch.isfinite(tmodel.predict(torch.from_numpy(x),
                                             step_size=0.1)).all()


# -- the cached twins ---------------------------------------------------------

KW = dict(out_dim=10, act="GroupSort", mu=(0.5,), std=(0.25,))


@pytest.fixture(scope="module")
def kwlarge():
    """A KWLarge pair on 16 x 16 images (the smallest the four convs take)
    and the JAX package's cached twin of it."""
    x = _x((2, 3, 16, 16), 4)
    jnet = JaxKWLarge(**KW)
    params = jnet.init(jax.random.PRNGKey(5), jnp.asarray(x))
    jcached = JaxKWLarge(cached=True, **KW)
    cparams = jax_cache(jcached, params, jnp.asarray(x))
    tnet = KWLargeBackbone(img_size=16, **KW)
    params_from_numpy(tnet, _np(params["params"]))
    return x, jnet, params, jcached, cparams, tnet


def test_cached_twin_matches_jax_cached_twin(kwlarge):
    x, jnet, params, jcached, cparams, tnet = kwlarge
    tcached = make_backbone("ORTHO_KWLarge_Concat_test", in_channels=3,
                            img_size=16, **KW)
    cache_cayley_params(tcached, tnet)
    want = jax.jit(jcached.apply)(cparams, jnp.asarray(x))
    with torch.no_grad():
        got = tcached(torch.from_numpy(x))
        plain = tnet(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FEAT_TOL)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-6)
    # the JAX twin's complex Q crosses to Qr / Qi and back
    loaded = make_backbone("ORTHO_KWLarge_Concat_test", in_channels=3,
                           img_size=16, **KW)
    params_from_numpy(loaded, _np(cparams["params"]))
    for (name, a), (_, b) in zip(loaded.named_parameters(),
                                 tcached.named_parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=1e-5, err_msg=name)
    q = params_to_numpy(loaded)["CayleyConv_1"]["Q"]
    want_q = np.asarray(cparams["params"]["CayleyConv_1"]["Q"])
    assert q.dtype == np.complex64 and q.shape == (8, 5, 32, 128)
    np.testing.assert_array_equal(q, want_q)


def test_cached_classifier_predicts_as_the_uncached_one(kwlarge):
    x, _, _, _, _, tnet = kwlarge
    dyn = SimplexDynamics(activation="ReLU", **DYN)
    model = NeuralODEClassifier(tnet, dyn, max_steps=32)
    twin = NeuralODEClassifier(
        KWLargeBackbone(img_size=16, cached=True, **KW),
        SimplexDynamics(activation="ReLU", **DYN), max_steps=32)
    cache_cayley_params(twin, model)
    with torch.no_grad():
        a, b = model.solve(torch.from_numpy(x)), twin.solve(torch.from_numpy(x))
    assert a.nfe == b.nfe
    np.testing.assert_allclose(b.ys.numpy(), a.ys.numpy(), atol=1e-6)


def test_unfilled_twin_is_nan():
    net = KWLargeBackbone(img_size=16, cached=True, **KW)
    with torch.no_grad():
        assert torch.isnan(net(torch.from_numpy(_x((2, 3, 16, 16))))).all()
    with torch.no_grad():
        lin = CayleyLinear(4, 3, cached=True)
        assert torch.isnan(lin(torch.ones(1, 4))).all()


def test_inter_matches_jax(kwlarge):
    x, _, params, _, _, _ = kwlarge
    jinter = JaxKWLarge(inter=True, **KW)
    p = {"params": {k: v for k, v in params["params"].items()
                    if k != "CayleyLinear_2"}}
    want = jax.jit(jinter.apply)(p, jnp.asarray(x))
    tinter = make_backbone("ORTHO_KWLarge_inter", in_channels=3, img_size=16,
                           **KW)
    params_from_numpy(tinter, _np(p["params"]))
    with torch.no_grad():
        got = tinter(torch.from_numpy(x))
    assert tuple(got.shape) == (2, 512)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FEAT_TOL)


@pytest.mark.parametrize("layer", ["linear", "conv", "conv_cached"])
def test_use_bias_false_matches_jax(layer):
    if layer == "linear":
        x = _x((3, 6))
        jl = JaxCayleyLinear(5, use_bias=False)
        tl = CayleyLinear(6, 5, use_bias=False)
    else:
        x = _x((2, 4, 8, 8))
        jl = JaxCayleyConv(6, 3, use_bias=False)
        tl = CayleyConv(4, 6, 3, use_bias=False)
    p = jl.init(jax.random.PRNGKey(6), jnp.asarray(x))
    if layer == "conv_cached":
        jl = JaxCayleyConv(6, 3, use_bias=False, cached=True)
        p = jax_cache(jl, p, jnp.asarray(x))
        tl = CayleyConv(4, 6, 3, use_bias=False, cached=True, img_size=8)
        params_from_numpy(tl, _np(p["params"]))
    else:
        params_from_numpy(tl, _np(p["params"]))
    assert tl.bias is None
    want = jax.jit(jl.apply)(p, jnp.asarray(x))
    with torch.no_grad():
        got = tl(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FEAT_TOL)


@pytest.mark.parametrize("n", [8, 7, 16])
def test_dft1_equals_dft_and_jax(n):
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.normal(size=(3, 4, n, n)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(6, 4, 3, 3)).astype(np.float32))
    Q = cayley_conv_kernel(w, torch.tensor(1.3), n)
    got = apply_freq_matrices(x, Q, impl="dft1")
    np.testing.assert_allclose(got.numpy(),
                               apply_freq_matrices(x, Q, impl="dft").numpy(),
                               atol=1e-5)
    want = jax_apply(jnp.asarray(x.numpy()), jnp.asarray(Q.numpy()),
                     impl="dft1")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
