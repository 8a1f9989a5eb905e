"""Port parity for every solver of ``fiode_tpu_torch/ode``: each tableau
equals the JAX one; odeint with each adaptive method (non-FSAL stepping and
the DOP853 error included) and each fixed-grid method gives the JAX
while-mode solution with the same NFE, accepted and rejected counts on a
decay, a stiff-ish nonlinear system and the tiny simplex classifier's RHS;
the error_weight seminorm, a non-FSAL method's exhausted budget and
scipy_solver match too; and the golden dopri5 fixture of
tests/test_golden_dopri5.py holds for the port (CPU, float32)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_fused_rhs import make_model
from test_golden_dopri5 import GOLDEN, rhs_f64
from test_golden_dopri5 import make_model as golden_model

from fiode_tpu.models.dynamics import densify_dynamics_params
from fiode_tpu.ode.integrate import odeint as jax_odeint
from fiode_tpu.ode.tableaus import get_tableau as jax_tableau
from fiode_tpu_torch import params_from_numpy
from fiode_tpu_torch.models.backbones import TinyMLPBackbone
from fiode_tpu_torch.models.dynamics import SimplexDynamics
from fiode_tpu_torch.models.ivp import NeuralODEClassifier
from fiode_tpu_torch.ode.integrate import odeint
from fiode_tpu_torch.ode.tableaus import (ADAPTIVE_SOLVERS, FIXED_SOLVERS,
                                          get_tableau)

TOL = 1e-5
# the simplex RHS's own tolerance against JAX (tests/test_torch_fused_rhs.py):
# a 1-ulp difference of exp, times alpha_1 = 100, is 2 alpha_1 2^-23
RHS_TOL = 2.4e-5
ALL_TABLEAUS = ADAPTIVE_SOLVERS + ("euler", "midpoint", "rk4")


@pytest.mark.parametrize("name", ALL_TABLEAUS)
def test_tableau_equals_jax(name):
    got, want = get_tableau(name), jax_tableau(name)
    for field in ("c", "a", "b", "err", "err5", "err3"):
        g, w = getattr(got, field), getattr(want, field)
        assert (g is None) == (w is None), field
        if w is not None:
            np.testing.assert_array_equal(g, w, err_msg=field)
    for field in ("order", "fsal", "dop853_err"):
        assert getattr(got, field) == getattr(want, field), field


def test_unknown_method_raises():
    with pytest.raises(ValueError, match="Unknown RK method"):
        get_tableau("dopri7")
    with pytest.raises(ValueError, match="needs step_size"):
        odeint(lambda t, y: -y, torch.ones(2), [0.0, 1.0], method="rk4")


# -- the three problems -------------------------------------------------------


def _decay():
    y0 = np.random.default_rng(0).uniform(0.5, 1.5, (4, 3)).astype(np.float32)
    return (y0, lambda t, y, args: -y, lambda t, y: -y)


def _stiffish():
    rng = np.random.default_rng(2)
    y0 = rng.uniform(0.5, 1.5, (4, 3)).astype(np.float32)
    A = rng.normal(size=(3, 3)).astype(np.float32)
    At = torch.from_numpy(A)

    def f_jax(t, y, args):
        return -20.0 * y ** 3 + jnp.sin(3.0 * t) * (y @ A)

    def f_torch(t, y):
        return -20.0 * y ** 3 + torch.sin(3.0 * t) * (y @ At)

    return y0, f_jax, f_torch


def _simplex():
    """The tiny classifier's RHS (n = 10, mlp = 32) on fixed features."""
    jmodel, params, x = make_model()
    feats = np.array(jmodel.features(params, x))
    d = jmodel.dynamics
    tdyn = SimplexDynamics(n_hidden=d.n_hidden, mlp_size=d.mlp_size,
                           x_dim=d.x_dim, dropout=0.0, alpha_1=d.alpha_1,
                           alpha_2=d.alpha_2, sigma_1=d.sigma_1)
    params_from_numpy(tdyn, jax.tree_util.tree_map(np.asarray,
                                                   params["dynamics"]))
    ft = torch.from_numpy(feats)
    y0 = np.full((feats.shape[0], d.n_hidden), 1.0 / d.n_hidden, np.float32)
    return (y0, lambda t, h, args: jmodel.eval_dot(params, h, feats),
            lambda t, h: tdyn.eval_dot(h, ft))


PROBLEMS = {"decay": _decay, "stiffish": _stiffish, "simplex": _simplex}
# ts, rtol / atol, step_size of each problem.  The decay's error estimate
# is round-off (its stages cancel), so its step sizes agree only to that
# rounding and a Hermite point inside a step by ~1e-5: it is held at the
# end time, the other two problems at interior times too.
SETTINGS = {"decay": ([0.0, 1.0], 1e-4, 0.1),
            "stiffish": ([0.0, 0.5, 2.0], 1e-4, 0.02),
            "simplex": ([0.0, 0.5, 1.0], 1e-3, 0.05)}


def _both(problem, method, **kw):
    y0, f_jax, f_torch = PROBLEMS[problem]()
    ts, tol, step = SETTINGS[problem]
    kw = dict(dict(method=method, rtol=tol, atol=tol, step_size=step), **kw)
    want = jax.jit(lambda y: jax_odeint(f_jax, y, jnp.asarray(ts), **kw))(
        jnp.asarray(y0))
    with torch.no_grad():
        got = odeint(f_torch, torch.from_numpy(y0), ts, **kw)
    return got, want


def _assert_same(got, want, tol=TOL):
    assert (got.nfe, got.n_accepted, got.n_rejected) == (
        int(want.nfe), int(want.n_accepted), int(want.n_rejected))
    assert tuple(got.ys.shape) == tuple(want.ys.shape)
    np.testing.assert_allclose(got.ys.numpy(), np.asarray(want.ys), atol=tol)


@pytest.mark.parametrize("problem", sorted(PROBLEMS))
@pytest.mark.parametrize("method", ADAPTIVE_SOLVERS)
def test_adaptive_method_matches_jax(method, problem):
    got, want = _both(problem, method)
    _assert_same(got, want, RHS_TOL if problem == "simplex" else TOL)


@pytest.mark.parametrize("problem", sorted(PROBLEMS))
@pytest.mark.parametrize("method", FIXED_SOLVERS)
def test_fixed_method_matches_jax(method, problem):
    got, want = _both(problem, method)
    assert got.nfe > 0 and got.n_accepted == got.n_rejected == 0
    _assert_same(got, want, RHS_TOL if problem == "simplex" else TOL)


def test_cases_include_rejections_and_non_fsal_steps():
    got, _ = _both("stiffish", "fehlberg2")
    assert got.n_rejected > 0
    # a non-FSAL method evaluates f(t1, y1) only on acceptance
    assert got.nfe == 2 + 2 * got.attempts + got.n_accepted


def test_adams_history_runs_across_a_dense_grid():
    # one substep a segment: the history must survive each output time
    ts = np.linspace(0.0, 1.0, 21).astype(np.float32).tolist()
    y0 = torch.ones(2)
    dense = odeint(lambda t, y: -y, y0, ts, method="implicit_adams",
                   step_size=0.05)
    want = jax.jit(lambda y: jax_odeint(lambda t, y, a: -y, y, jnp.asarray(ts),
                                        method="implicit_adams",
                                        step_size=0.05))(jnp.ones(2))
    _assert_same(dense, want)
    assert dense.nfe == 3 * 4 + 17 * 5


def test_error_weight_matches_jax():
    y0, f_jax, f_torch = _stiffish()
    w = np.zeros(y0.shape, np.float32)
    w[:, :2] = 1.0
    ts = [0.0, 0.5, 2.0]
    want = jax.jit(lambda y: jax_odeint(
        f_jax, y, jnp.asarray(ts), method="bosh3", rtol=1e-4, atol=1e-4,
        error_weight=jnp.asarray(w)))(jnp.asarray(y0))
    got = odeint(f_torch, torch.from_numpy(y0), ts, method="bosh3",
                 rtol=1e-4, atol=1e-4, error_weight=torch.from_numpy(w))
    full = odeint(f_torch, torch.from_numpy(y0), ts, method="bosh3",
                  rtol=1e-4, atol=1e-4)
    _assert_same(got, want)
    assert got.nfe != full.nfe  # the weight changed the step control


def test_exhausted_budget_of_a_non_fsal_method_matches_jax():
    got, want = _both("stiffish", "adaptive_heun", max_steps=5)
    assert got.attempts == 5
    assert (got.nfe, got.n_accepted, got.n_rejected) == (
        int(want.nfe), int(want.n_accepted), int(want.n_rejected))
    # the unreached outputs are the last state
    np.testing.assert_array_equal(got.ys[1].numpy(), got.ys[2].numpy())
    np.testing.assert_allclose(got.ys.numpy(), np.asarray(want.ys), atol=1e-4)


def test_scipy_solver_matches_jax():
    y0, f_jax, f_torch = _stiffish()
    ts = [0.0, 0.5, 2.0]
    want = jax_odeint(f_jax, jnp.asarray(y0), jnp.asarray(ts),
                      method="scipy_solver", rtol=1e-6, atol=1e-6)
    got = odeint(f_torch, torch.from_numpy(y0), ts, method="scipy_solver",
                 rtol=1e-6, atol=1e-6)
    assert got.ys.dtype == torch.float32 and got.nfe == 0
    np.testing.assert_allclose(got.ys.numpy(), np.asarray(want.ys), atol=TOL)


# -- the golden dopri5 fixture -----------------------------------------------


@pytest.fixture(scope="module")
def golden():
    jmodel, params, x = golden_model()
    d = jmodel.dynamics
    tmodel = NeuralODEClassifier(
        TinyMLPBackbone(64, out_dim=d.x_dim, hidden=16, mu=(0.5,),
                        std=(0.25,)),
        SimplexDynamics(n_hidden=d.n_hidden, mlp_size=d.mlp_size,
                        x_dim=d.x_dim, dropout=0.0, alpha_1=d.alpha_1,
                        alpha_2=d.alpha_2, sigma_1=d.sigma_1),
        max_steps=jmodel.max_steps)
    params_from_numpy(tmodel, jax.tree_util.tree_map(np.asarray, params))
    return jmodel, params, tmodel, np.asarray(x)


def test_golden_step_sequence(golden):
    _, _, tmodel, x = golden
    with torch.no_grad():
        sol = tmodel.solve(torch.from_numpy(x))
    assert (sol.nfe, sol.n_accepted, sol.n_rejected) == (
        GOLDEN["nfe"], GOLDEN["n_accepted"], GOLDEN["n_rejected"])


def test_golden_endpoint_matches_float64_oracle(golden):
    from scipy.integrate import solve_ivp

    jmodel, params, tmodel, x = golden
    with torch.no_grad():
        end = tmodel.solve(torch.from_numpy(x)).ys[-1].double().numpy()
    feats = np.asarray(jmodel.features(params, jnp.asarray(x)), np.float64)
    f = rhs_f64(densify_dynamics_params(params["dynamics"]), feats)
    B, n = end.shape
    ref = solve_ivp(lambda t, y: f(y.reshape(B, n)).reshape(-1),
                    (0.0, float(tmodel.t_max)), np.full(B * n, 1.0 / n),
                    method="RK45", rtol=1e-9, atol=1e-12)
    assert ref.success
    assert np.abs(end - ref.y[:, -1].reshape(B, n)).max() < 5e-3
    np.testing.assert_allclose(end.sum(-1), 1.0, atol=1e-4)


def test_model_method_matches_jax(golden):
    jmodel, params, tmodel, x = golden
    jm = dataclasses.replace(jmodel, method="bosh3")
    want = jax.jit(lambda p, x: jm.solve(p, x, rtol=1e-4, atol=1e-4))(
        params, jnp.asarray(x))
    with torch.no_grad():
        got = tmodel.solve(torch.from_numpy(x), method="bosh3", rtol=1e-4,
                           atol=1e-4)
    _assert_same(got, want)
