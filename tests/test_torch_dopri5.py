"""Port parity for adaptive dopri5: the tableau copy equals the JAX one, and
odeint on small nonlinear ODEs gives the JAX while-mode solution with the
same NFE, accepted and rejected step counts (CPU, float32)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fiode_tpu.ode.integrate import odeint as jax_odeint
from fiode_tpu.ode.tableaus import get_tableau as jax_tableau
from fiode_tpu_torch.ode.integrate import odeint
from fiode_tpu_torch.ode.tableaus import DOPRI5

TOL = 1e-5


def test_tableau_equals_jax():
    want = jax_tableau("dopri5")
    for field in ("c", "a", "b", "err"):
        np.testing.assert_array_equal(getattr(DOPRI5, field),
                                      getattr(want, field))
    assert (DOPRI5.order, DOPRI5.fsal) == (want.order, want.fsal)


def _problem(seed, stiff):
    rng = np.random.default_rng(seed)
    y0 = rng.uniform(0.5, 1.5, (4, 3)).astype(np.float32)
    A = rng.normal(size=(3, 3)).astype(np.float32)
    k = np.float32(stiff)

    def f_jax(t, y, args):
        return -k * y ** 3 + jnp.sin(3.0 * t) * (y @ args)

    def f_torch(t, y):
        return -k * y ** 3 + torch.sin(3.0 * t) * (y @ torch.from_numpy(A))

    return y0, A, f_jax, f_torch


CASES = [
    # seed, stiffness, ts, rtol, max_steps
    (0, 1.0, [0.0, 1.0], 1e-3, 512),
    (1, 1.0, [0.0, 0.3, 0.7, 1.5], 1e-3, 512),
    (2, 20.0, [0.0, 0.5, 2.0], 1e-4, 512),   # rejections on the way
]


@pytest.mark.parametrize("seed,stiff,ts,rtol,max_steps", CASES)
def test_odeint_matches_jax(seed, stiff, ts, rtol, max_steps):
    y0, A, f_jax, f_torch = _problem(seed, stiff)
    want = jax.jit(
        lambda y, a: jax_odeint(f_jax, y, jnp.asarray(ts), a, method="dopri5",
                                rtol=rtol, atol=rtol, max_steps=max_steps)
    )(jnp.asarray(y0), jnp.asarray(A))
    got = odeint(f_torch, torch.from_numpy(y0), ts, rtol=rtol, atol=rtol,
                 max_steps=max_steps)
    assert (got.nfe, got.n_accepted, got.n_rejected) == (
        int(want.nfe), int(want.n_accepted), int(want.n_rejected))
    assert got.ys.shape == (len(ts),) + y0.shape
    np.testing.assert_allclose(got.ys.numpy(), np.asarray(want.ys), atol=TOL)


def test_cases_include_rejected_steps():
    y0, _, _, f_torch = _problem(2, 20.0)
    sol = odeint(f_torch, torch.from_numpy(y0), [0.0, 0.5, 2.0], rtol=1e-4,
                 atol=1e-4)
    assert sol.n_rejected > 0


def test_exhausted_step_budget_matches_jax():
    # 6 steps reach t = 0.2 but not 1.0: the unreached outputs are clamped to
    # the last state.  Step sizes agree only to the rounding of the error
    # estimate, so the last state is compared by its clamping, not by value.
    ts, max_steps = [0.0, 0.2, 1.0, 3.0], 6
    y0, A, f_jax, f_torch = _problem(3, 5.0)
    want = jax.jit(
        lambda y, a: jax_odeint(f_jax, y, jnp.asarray(ts), a, method="dopri5",
                                rtol=1e-5, atol=1e-5, max_steps=max_steps)
    )(jnp.asarray(y0), jnp.asarray(A))
    got = odeint(f_torch, torch.from_numpy(y0), ts, rtol=1e-5, atol=1e-5,
                 max_steps=max_steps)
    assert (got.nfe, got.n_accepted, got.n_rejected) == (
        int(want.nfe), int(want.n_accepted), int(want.n_rejected))
    assert got.n_accepted + got.n_rejected == max_steps
    np.testing.assert_allclose(got.ys[:2].numpy(), np.asarray(want.ys[:2]),
                               atol=TOL)
    np.testing.assert_array_equal(got.ys[2].numpy(), got.ys[3].numpy())
    np.testing.assert_allclose(got.ys[3].numpy(), np.asarray(want.ys[3]),
                               atol=1e-4)
