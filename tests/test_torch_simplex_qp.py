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


# -- the two-sided box projection and the closed-form cone duals ---------------

from fiode_tpu.ops.simplex_qp import simplex_box_project as jax_box  # noqa: E402
from fiode_tpu_torch.ops.simplex_qp import (  # noqa: E402
    box_project_mu,
    simplex_box_project,
)

BOX_TOL = 1e-6  # the same 30 halvings of the same bracket in both frameworks
FD_EPS, FD_RTOL = 1e-3, 0.08  # central differences, as tests/test_simplex_qp.py


def _box_inputs(B, n, seed, scale, alpha_2):
    lower, nominal, g = _inputs(B, n, seed, scale)
    h = -np.log1p(-lower / 100.0) / 0.02
    upper = (alpha_2 * (1.0 - h)).astype(np.float32)
    return lower, upper, nominal, g


def _mixed_rows(seed=11, n=6):
    """Rows that clamp against both bounds and keep a strict free set: two
    coordinates far above the upper bound, two far below the lower, two
    inside the box."""
    rng = np.random.default_rng(seed)
    lower = np.full((4, n), -0.35, np.float32)
    upper = np.full((4, n), 0.25, np.float32)
    base = np.array([2.0, 1.5, -2.0, -1.7, 0.08, -0.05], np.float32)
    nominal = base + rng.normal(scale=0.02, size=(4, n)).astype(np.float32)
    g = rng.normal(size=(4, n)).astype(np.float32)
    return lower, upper, nominal, g


BOX_CASES = {
    "cifar_barrier": lambda: _box_inputs(16, 10, 0, 1.0, 20.0),
    "tight_upper": lambda: _box_inputs(37, 10, 1, 5.0, 5.0),
    "narrow": lambda: _box_inputs(8, 3, 2, 0.3, 20.0),
    "mixed_active": _mixed_rows,
}


@pytest.mark.parametrize("case", list(BOX_CASES))
def test_box_projection_matches_jax(case):
    lower, upper, nominal, _ = BOX_CASES[case]()
    want = np.asarray(jax_box(jnp.asarray(lower), jnp.asarray(upper),
                              jnp.asarray(nominal), 30))
    lo, up, no = (torch.from_numpy(a) for a in (lower, upper, nominal))
    got = simplex_box_project(lo, up, no, 30).numpy()
    np.testing.assert_allclose(got, want, atol=BOX_TOL)
    np.testing.assert_allclose(got.sum(-1), 0.0, atol=2e-4)
    assert (got >= lower - 1e-6).all() and (got <= upper + 1e-6).all()
    mu = box_project_mu(lo, up, no, 30)
    np.testing.assert_allclose(torch.clamp(no - mu, lo, up).numpy(), got,
                               atol=0)


@pytest.mark.parametrize("case", list(BOX_CASES))
def test_box_vjp_matches_jax(case):
    lower, upper, nominal, g = BOX_CASES[case]()
    _, vjp = jax.vjp(lambda lo, up, no: jax_box(lo, up, no, 30),
                     jnp.asarray(lower), jnp.asarray(upper),
                     jnp.asarray(nominal))
    want = [np.asarray(a) for a in vjp(jnp.asarray(g))]
    leaves = [torch.from_numpy(a).requires_grad_()
              for a in (lower, upper, nominal)]
    out = simplex_box_project(*leaves, 30)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b, atol=TOL)


@pytest.mark.parametrize("case", ["tight_upper", "mixed_active"])
def test_box_vjp_matches_central_differences(case):
    lower, upper, nominal, _ = BOX_CASES[case]()
    lower, upper, nominal = lower[:4], upper[:4], nominal[:4]
    n = lower.shape[1]
    w = torch.arange(1.0, n + 1.0, dtype=torch.float64)

    def loss(lo, up, no):
        return (torch.cos(simplex_box_project(lo, up, no, 40)) * w).sum()

    args = [torch.from_numpy(a).double() for a in (lower, upper, nominal)]
    if case == "mixed_active":
        v = simplex_box_project(*args, 40)
        la = (v <= args[0] + 1e-6).sum(-1)
        ua = (v >= args[1] - 1e-6).sum(-1)
        assert (la > 0).all() and (ua > 0).all() and ((la + ua) < n).all()
    leaves = [a.clone().requires_grad_() for a in args]
    grads = torch.autograd.grad(loss(*leaves), leaves)
    for k in range(3):
        for i in range(lower.shape[0]):
            for j in range(n):
                d = torch.zeros_like(args[k])
                d[i, j] = FD_EPS
                plus = [a + d if m == k else a for m, a in enumerate(args)]
                minus = [a - d if m == k else a for m, a in enumerate(args)]
                fd = float(loss(*plus) - loss(*minus)) / (2 * FD_EPS)
                an = float(grads[k][i, j])
                assert abs(fd - an) <= FD_RTOL * max(1.0, abs(fd)), (
                    f"arg{k}[{i},{j}]: fd={fd:.5f} analytic={an:.5f}")


@pytest.mark.parametrize("method", ["exact", "sort"])
@pytest.mark.parametrize("B,n,seed,scale", CASES)
def test_closed_form_duals_match_bisect_and_jax(method, B, n, seed, scale):
    lower, nominal, g = _inputs(B, n, seed, scale)
    lo, no = torch.from_numpy(lower), torch.from_numpy(nominal)
    got = simplex_cone_project(lo, no, 30, method)
    bisect = simplex_cone_project(lo, no, 30)
    # the bisection stops at a bracket of (initial width) 2^-30; float32
    # round-off of the sums is what is left
    width = float((no - lo).amax() - no.amin()) * 2.0 ** -30
    np.testing.assert_allclose(got.numpy(), bisect.numpy(),
                               atol=max(width, 5e-6))
    want = np.asarray(jax_project(jnp.asarray(lower), jnp.asarray(nominal),
                                  30, False, method))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)
    np.testing.assert_allclose(got.numpy().sum(-1), 0.0, atol=1e-4)
    # the VJP takes the same active set
    lo_g, no_g = lo.clone().requires_grad_(), no.clone().requires_grad_()
    grads = torch.autograd.grad(simplex_cone_project(lo_g, no_g, 30, method),
                                (lo_g, no_g), torch.from_numpy(g))
    lo_b, no_b = lo.clone().requires_grad_(), no.clone().requires_grad_()
    grads_b = torch.autograd.grad(simplex_cone_project(lo_b, no_b, 30),
                                  (lo_b, no_b), torch.from_numpy(g))
    for a, b in zip(grads, grads_b):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5)


@pytest.mark.parametrize("method", ["exact", "sort"])
def test_closed_form_duals_on_ties_and_degenerate_rows(method):
    n = 6
    lower = torch.full((3, n), -0.5)
    nominal = torch.stack([
        torch.full((n,), 0.3),                              # all tied
        torch.tensor([1.0, 1, 1, -1, -1, -1]),              # two tie groups
        torch.arange(n, dtype=torch.float32),
    ])
    got = simplex_cone_project(lower, nominal, 30, method)
    want = simplex_cone_project(lower.double(), nominal.double(), 80)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-6)
    # s == 0: the only feasible point is v == lower == 0
    z = torch.zeros(2, n)
    v0 = simplex_cone_project(z, z + torch.tensor([0.0, 1.0])[:, None], 30,
                              method)
    np.testing.assert_allclose(v0.numpy(), 0.0, atol=1e-6)


def test_unknown_method_rejected():
    lo, no = torch.zeros(2, 3), torch.ones(2, 3)
    with pytest.raises(ValueError):
        simplex_cone_project(lo, no, 30, "newton")
