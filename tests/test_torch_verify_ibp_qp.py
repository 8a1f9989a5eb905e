"""Port parity: interval propagation through the barrier QP and the
scale-nominal sigmoid, and the worst-case Vdot (fiode_tpu_torch.verify.ibp_qp)
against the JAX package on the same numpy inputs (CPU, float32).

PARITY_TOL = 1e-5: the bounds are outputs of a 30-step bisection on the same
bracket in both frameworks, of size O(1) to O(10) (alpha_2 = 20).
Soundness is held by sampling projections inside the box (2e-3, the
bisection's residual, as tests/test_verify.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fiode_tpu.verify import ibp_qp as jqp
from fiode_tpu_torch.ops.simplex_qp import (simplex_box_project,
                                            simplex_cone_project)
from fiode_tpu_torch.verify import ibp_qp as tqp

A1, A2, S1 = 100.0, 20.0, 0.02
PARITY_TOL = 1e-5
SOUND_TOL = 2e-3


def _cells(seed, N=16, n=5, width=0.3):
    rng = np.random.default_rng(seed)
    h = rng.uniform(size=(N, n))
    h = (h / h.sum(-1, keepdims=True)).astype(np.float32)
    mid = rng.normal(size=(N, n)).astype(np.float32)
    eps_rows = rng.uniform(0.005, 0.04, size=(N, n)).astype(np.float32)
    return h, mid - width, mid + width, eps_rows


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _assert_pair(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=PARITY_TOL)


@pytest.mark.parametrize("with_upper", [False, True])
@pytest.mark.parametrize("seed", [3, 4])
def test_ibp_cbf_qp_matches_jax(seed, with_upper):
    h, lb, ub, _ = _cells(seed)
    want = jqp.ibp_cbf_qp(*_j(h), 0.02, *_j(lb, ub), A1, S1, A2,
                          with_upper=with_upper)
    got = tqp.ibp_cbf_qp(*_t(h), 0.02, *_t(lb, ub), A1, S1, A2,
                         with_upper=with_upper)
    _assert_pair(got, want)
    assert (got[0] <= got[1] + 1e-5).all()


@pytest.mark.parametrize("with_upper", [False, True])
def test_ibp_cbf_qp_band_matches_jax_on_an_asymmetric_box(with_upper):
    h, lb, ub, _ = _cells(8, N=8)
    h_lb, h_ub = h - 0.01, h + 0.05
    want = jqp.ibp_cbf_qp_band(*_j(h_lb, h_ub, lb, ub), A1, S1, A2,
                               with_upper=with_upper)
    got = tqp.ibp_cbf_qp_band(*_t(h_lb, h_ub, lb, ub), A1, S1, A2,
                              with_upper=with_upper)
    _assert_pair(got, want)


def test_band_form_equals_centre_eps_form():
    h, lb, ub, _ = _cells(6, N=8, width=0.2)
    h_t, lb_t, ub_t = _t(h, lb, ub)
    f1 = tqp.ibp_cbf_qp(h_t, 0.03, lb_t, ub_t, A1, S1, A2)
    f2 = tqp.ibp_cbf_qp_band(h_t - 0.03, h_t + 0.03, lb_t, ub_t, A1, S1, A2)
    for a, b in zip(f1, f2):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


def test_per_dim_eps_matches_jax():
    h, lb, ub, eps_rows = _cells(9)
    want = jqp.ibp_cbf_qp(*_j(h, eps_rows, lb, ub), A1, S1, A2)
    got = tqp.ibp_cbf_qp(*_t(h, eps_rows, lb, ub), A1, S1, A2)
    _assert_pair(got, want)


def test_ibp_cbf_qp_individual_matches_jax():
    h, lb, ub, _ = _cells(11, N=8)
    want = jqp.ibp_cbf_qp_individual(*_j(h), 0.02, *_j(lb, ub), A1, S1, A2)
    got = tqp.ibp_cbf_qp_individual(*_t(h), 0.02, *_t(lb, ub), A1, S1, A2)
    _assert_pair(got, want)


@pytest.mark.parametrize("method", ["exact", "sort"])
def test_closed_form_method_gives_the_bisection_bounds(method):
    h, lb, ub, _ = _cells(12)
    base = tqp.ibp_cbf_qp(*_t(h), 0.02, *_t(lb, ub), A1, S1, A2)
    got = tqp.ibp_cbf_qp(*_t(h), 0.02, *_t(lb, ub), A1, S1, A2, method=method)
    for a, b in zip(got, base):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


def test_ibp_sigmoid_matches_jax_and_is_sound():
    h, lb, ub, _ = _cells(13)
    eps = 0.02
    want = jqp.ibp_sigmoid(*_j(lb, ub, h - eps, h + eps), A1, S1, A2)
    got = tqp.ibp_sigmoid(*_t(lb, ub, h - eps, h + eps), A1, S1, A2)
    _assert_pair(got, want)
    rng = np.random.default_rng(14)
    for _ in range(20):
        hp = h + rng.uniform(-eps, eps, size=h.shape)
        f = lb + (ub - lb) * rng.uniform(size=h.shape)
        lower = -A1 * (np.exp(S1 * hp) - 1.0)
        val = (A2 * (1.0 - hp) - lower) / (1.0 + np.exp(-f)) + lower
        assert (val >= got[0].numpy() - 1e-4).all()
        assert (val <= got[1].numpy() + 1e-4).all()


@pytest.mark.parametrize("form", ["cone", "individual", "band"])
def test_qp_interval_contains_sampled_projections(form):
    h, lb, ub, _ = _cells(15)
    eps = 0.02
    h_lo, h_hi = (h - 0.01, h + 0.05) if form == "band" else (h - eps, h + eps)
    if form == "individual":
        f_lb, f_ub = tqp.ibp_cbf_qp_individual(*_t(h), eps, *_t(lb, ub), A1,
                                               S1, A2)
    else:
        f_lb, f_ub = tqp.ibp_cbf_qp_band(*_t(h_lo, h_hi, lb, ub), A1, S1, A2)
    f_lb, f_ub = f_lb.numpy(), f_ub.numpy()
    assert (f_lb <= f_ub + 1e-5).all()
    rng = np.random.default_rng(16)
    for _ in range(25):
        hp = torch.from_numpy(
            (h_lo + (h_hi - h_lo) * rng.uniform(size=h.shape)).astype(np.float32))
        ft = torch.from_numpy(
            (lb + (ub - lb) * rng.uniform(size=h.shape)).astype(np.float32))
        if form == "individual":
            v = simplex_box_project(-A1 * hp, A2 * (1.0 - hp), ft, 40)
        else:
            v = simplex_cone_project(-A1 * (torch.exp(S1 * hp) - 1.0), ft, 40)
        assert (v.numpy() >= f_lb - SOUND_TOL).all()
        assert (v.numpy() <= f_ub + SOUND_TOL).all()


@pytest.mark.parametrize("eps_kind", ["scalar", "per_dim"])
def test_worst_case_vdot_matches_jax(eps_kind):
    rng = np.random.default_rng(17)
    N, n = 64, 5
    # lattice-like values with many ties in the runner-up set
    eta = (rng.integers(0, 5, size=(N, n)) / 8.0).astype(np.float32)
    f_lb = rng.normal(size=(N, n)).astype(np.float32)
    f_ub = f_lb + rng.uniform(0.0, 1.0, size=(N, n)).astype(np.float32)
    label = rng.integers(0, n, size=N)
    eps = 0.0625 if eps_kind == "scalar" else rng.uniform(
        0.01, 0.1, size=(N, n)).astype(np.float32)
    jeps = eps if eps_kind == "scalar" else jnp.asarray(eps)
    teps = eps if eps_kind == "scalar" else torch.from_numpy(eps)
    want = np.stack([
        np.asarray(jqp.worst_case_vdot(jnp.asarray(eta[i:i + 1]),
                                       jeps if eps_kind == "scalar" else jeps[i:i + 1],
                                       jnp.asarray(f_lb[i:i + 1]),
                                       jnp.asarray(f_ub[i:i + 1]),
                                       int(label[i])))[0]
        for i in range(N)])
    got = tqp.worst_case_vdot(*_t(eta), teps, *_t(f_lb, f_ub),
                              torch.from_numpy(label))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    # one label for every row, as an int
    got0 = tqp.worst_case_vdot(*_t(eta), teps, *_t(f_lb, f_ub), 0)
    want0 = jqp.worst_case_vdot(jnp.asarray(eta), jeps, jnp.asarray(f_lb),
                                jnp.asarray(f_ub), 0)
    np.testing.assert_allclose(got0.numpy(), np.asarray(want0), atol=1e-6)


def test_worst_case_vdot_brute():
    eta = torch.tensor([[0.3, 0.3, 0.2, 0.2]])
    f_lb = torch.tensor([[-1.0, -2.0, -3.0, -4.0]])
    f_ub = torch.tensor([[1.0, 2.0, 3.0, 4.0]])
    # wide runner-up set: threshold 0.3 - 0.12 < 0.2 -> coordinates {1, 2, 3}
    assert float(tqp.worst_case_vdot(eta, 0.06, f_lb, f_ub, 0)[0]) \
        == pytest.approx(1.0 + 4.0)
    # tight runner-up set: threshold 0.3 - 0.02 > 0.2 -> coordinate {1} only
    assert float(tqp.worst_case_vdot(eta, 0.01, f_lb, f_ub, 0)[0]) \
        == pytest.approx(1.0 + 2.0)
