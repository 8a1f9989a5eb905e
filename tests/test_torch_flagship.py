"""End-to-end port parity of the flagship forward solve: the full-width
KWLarge / simplex neural-ODE classifier, initialised by the JAX package and
bridged into the port, predicts the same class probabilities with the same
NFE on seeded images (CPU, float32).  A small TinyMLP classifier checks the
same at narrow width, and the port's own flagship and entry() are checked
for shape and layout."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from fiode_tpu.models.backbones import TinyMLPBackbone as JaxTinyMLP
from fiode_tpu.models.dynamics import SimplexDynamics as JaxDynamics
from fiode_tpu.models.ivp import NeuralODEClassifier as JaxClassifier
from fiode_tpu_torch import entry, flagship, params_from_numpy
from fiode_tpu_torch.models.backbones import TinyMLPBackbone
from fiode_tpu_torch.models.dynamics import SimplexDynamics
from fiode_tpu_torch.models.ivp import NeuralODEClassifier

ENDPOINT_TOL = 1e-3
FEATURE_TOL = 1e-4


@pytest.fixture(scope="module")
def flagship_pair():
    jmodel = __graft_entry__._flagship()
    x = np.random.default_rng(0).uniform(size=(4, 3, 32, 32)).astype(np.float32)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    tmodel = flagship(generator=torch.Generator().manual_seed(1), device="cpu")
    params_from_numpy(tmodel, jax.tree_util.tree_map(np.asarray, params))
    return jmodel, params, tmodel, x


def test_flagship_features_match_jax(flagship_pair):
    jmodel, params, tmodel, x = flagship_pair
    want = np.asarray(jax.jit(jmodel.features)(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tmodel.features(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=FEATURE_TOL)


def test_flagship_predict_matches_jax(flagship_pair):
    jmodel, params, tmodel, x = flagship_pair
    want = jax.jit(lambda p, x: jmodel.solve(p, x))(params, jnp.asarray(x))
    with torch.no_grad():
        got = tmodel.solve(torch.from_numpy(x))
        probs = tmodel.predict(torch.from_numpy(x))
    np.testing.assert_allclose(got.ys[-1].numpy(), np.asarray(want.ys[-1]),
                               atol=ENDPOINT_TOL)
    np.testing.assert_array_equal(probs.numpy(), got.ys[-1].numpy())
    # identical step-control decisions
    assert (got.nfe, got.n_accepted, got.n_rejected) == (
        int(want.nfe), int(want.n_accepted), int(want.n_rejected))


@pytest.mark.parametrize("scale_nominal", [False, True])
def test_tiny_classifier_solve_matches_jax(scale_nominal):
    kw = dict(n_hidden=10, mlp_size=32, x_dim=10, dropout=0.0, alpha_1=100.0,
              alpha_2=20.0, sigma_1=0.02, scale_nominal=scale_nominal)
    jmodel = JaxClassifier(
        backbone=JaxTinyMLP(out_dim=10, hidden=16, mu=(0.5,), std=(0.25,)),
        dynamics=JaxDynamics(**kw), n_classes=10)
    x = np.random.default_rng(2).uniform(size=(6, 1, 8, 8)).astype(np.float32)
    params = jmodel.init(jax.random.PRNGKey(1), jnp.asarray(x))
    tmodel = NeuralODEClassifier(
        TinyMLPBackbone(64, out_dim=10, hidden=16, mu=(0.5,), std=(0.25,)),
        SimplexDynamics(**kw))
    params_from_numpy(tmodel, jax.tree_util.tree_map(np.asarray, params))
    ts = [0.0, 0.25, 0.5, 1.0]
    want = jax.jit(lambda p, x: jmodel.solve(p, x, jnp.asarray(ts)))(
        params, jnp.asarray(x))
    with torch.no_grad():
        got = tmodel.solve(torch.from_numpy(x), ts)
    np.testing.assert_allclose(got.ys.numpy(), np.asarray(want.ys),
                               atol=ENDPOINT_TOL)
    assert (got.nfe, got.n_accepted, got.n_rejected) == (
        int(want.nfe), int(want.n_accepted), int(want.n_rejected))


def test_port_flagship_layout_and_entry():
    model = flagship(generator=torch.Generator().manual_seed(0), device="cpu")
    shapes = [tuple(c.weight.shape) for c in model.backbone.convs]
    assert shapes == [(32, 3, 3, 3), (32, 128, 2, 2), (64, 32, 3, 3),
                      (64, 256, 2, 2)]
    assert [tuple(lin.weight.shape) for lin in model.backbone.linears] == [
        (512, 4096), (512, 512), (10, 512)]
    assert not model.training
    fn, (x,) = entry(device="cpu")
    with torch.no_grad():
        probs = fn(x)
    assert probs.shape == (8, 10)
    assert torch.isfinite(probs).all()
    np.testing.assert_allclose(probs.sum(-1).numpy(), 1.0, atol=1e-4)
