"""Port parity: the cone projection (bisect) and its closed-form VJP against
the JAX package, on the same numpy inputs (CPU, float32)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fiode_tpu.ops.simplex_qp import cone_project_mu as jax_mu
from fiode_tpu.ops.simplex_qp import simplex_cone_project as jax_project
from fiode_tpu_torch.ops.simplex_qp import cone_project_mu, simplex_cone_project

TOL = 1e-5


def _inputs(B, n, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    h = rng.uniform(0.0, 1.0, (B, n))
    h = (h / h.sum(-1, keepdims=True)).astype(np.float32)
    lower = (-100.0 * (np.exp(0.02 * h) - 1.0)).astype(np.float32)
    nominal = (scale * rng.normal(size=(B, n))).astype(np.float32)
    g = rng.normal(size=(B, n)).astype(np.float32)
    return lower, nominal, g


CASES = [(16, 10, 0, 1.0), (37, 10, 1, 5.0), (8, 3, 2, 0.3), (5, 32, 3, 2.0)]


@pytest.mark.parametrize("B,n,seed,scale", CASES)
def test_projection_matches_jax(B, n, seed, scale):
    lower, nominal, _ = _inputs(B, n, seed, scale)
    want = np.asarray(jax_project(jnp.asarray(lower), jnp.asarray(nominal), 30))
    got = simplex_cone_project(torch.from_numpy(lower),
                               torch.from_numpy(nominal), 30).numpy()
    np.testing.assert_allclose(got, want, atol=TOL)
    # the projection lands on the constraint set
    np.testing.assert_allclose(got.sum(-1), 0.0, atol=1e-3)
    assert (got >= lower - 1e-6).all()


@pytest.mark.parametrize("B,n,seed,scale", CASES)
def test_mu_matches_jax(B, n, seed, scale):
    lower, nominal, _ = _inputs(B, n, seed, scale)
    want = np.asarray(jax_mu(jnp.asarray(lower), jnp.asarray(nominal), 30))
    got = cone_project_mu(torch.from_numpy(lower), torch.from_numpy(nominal),
                          30).numpy()
    np.testing.assert_allclose(got, want, atol=TOL)


@pytest.mark.parametrize("B,n,seed,scale", CASES)
def test_vjp_matches_jax(B, n, seed, scale):
    lower, nominal, g = _inputs(B, n, seed, scale)
    _, vjp = jax.vjp(lambda lo, no: jax_project(lo, no, 30),
                     jnp.asarray(lower), jnp.asarray(nominal))
    want_lo, want_no = (np.asarray(a) for a in vjp(jnp.asarray(g)))

    lo_t = torch.from_numpy(lower).requires_grad_()
    no_t = torch.from_numpy(nominal).requires_grad_()
    out = simplex_cone_project(lo_t, no_t, 30)
    got_lo, got_no = torch.autograd.grad(out, (lo_t, no_t), torch.from_numpy(g))
    np.testing.assert_allclose(got_lo.numpy(), want_lo, atol=TOL)
    np.testing.assert_allclose(got_no.numpy(), want_no, atol=TOL)
