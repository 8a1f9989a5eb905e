"""The port's interval arithmetic (fiode_tpu_torch/verify/interval.py)
against the JAX package's on the same numpy boxes, and the soundness and
tightness checks of tests/test_control.py, mirrored."""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fiode_tpu.verify import interval as jiv
from fiode_tpu_torch.control.systems import Segway
from fiode_tpu_torch.verify.interval import IV, iv, iv_dot

TOL = 2e-6


def _boxes(seed, shape=(64,), lo=-4.0, hi=4.0, positive=False):
    rng = np.random.default_rng(seed)
    a = rng.uniform(lo, hi, size=shape).astype(np.float32)
    w = rng.uniform(0.0, 3.0, size=shape).astype(np.float32)
    if positive:
        a = np.abs(a) + 0.1
    return a, (a + w).astype(np.float32)


def _pair(lo, hi):
    return (jiv.IV(jnp.asarray(lo), jnp.asarray(hi)),
            IV(torch.from_numpy(lo), torch.from_numpy(hi)))


def _close(got: IV, want):
    np.testing.assert_allclose(got.lo.numpy(), np.asarray(want.lo), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.hi.numpy(), np.asarray(want.hi), rtol=TOL, atol=TOL)


# boxes that hold a peak, a trough, both, neither, and whole periods
TRIG_LO = np.array([1.4, -1.7, -2.0, 0.1, -7.0, 4.6, -4.8, 0.0, -0.3, 7.8],
                   np.float32)
TRIG_HI = np.array([1.7, -1.4, 2.0, 0.9, 7.0, 4.8, -4.6, 6.3, 0.3, 8.0],
                   np.float32)

OPS = {
    "add": lambda a, b, s: a + b,
    "add_scalar": lambda a, b, s: a + s + 0.5,
    "radd_scalar": lambda a, b, s: 0.5 + a,
    "sub": lambda a, b, s: a - b,
    "rsub_scalar": lambda a, b, s: 1.5 - a,
    "neg": lambda a, b, s: -a,
    "mul": lambda a, b, s: a * b,
    "mul_scalar": lambda a, b, s: a * -2.5,
    "rmul_scalar": lambda a, b, s: 0.7 * a,
    "div": lambda a, b, s: a / b,
    "div_scalar": lambda a, b, s: a / 0.2,
    "recip": lambda a, b, s: b.recip(),
    "square": lambda a, b, s: a.square(),
    "sin": lambda a, b, s: a.sin(),
    "cos": lambda a, b, s: a.cos(),
}


@pytest.mark.parametrize("op", sorted(OPS))
def test_iv_op_matches_jax(op):
    alo, ahi = _boxes(0)
    blo, bhi = _boxes(1, positive=True)  # a sign-definite divisor
    ja, ta = _pair(alo, ahi)
    jb, tb = _pair(blo, bhi)
    _close(OPS[op](ta, tb, 0.25), OPS[op](ja, jb, 0.25))


@pytest.mark.parametrize("fn", ["sin", "cos"])
def test_trig_on_peaks_and_troughs_matches_jax(fn):
    ja, ta = _pair(TRIG_LO, TRIG_HI)
    got, want = getattr(ta, fn)(), getattr(ja, fn)()
    _close(got, want)
    # and the enclosure holds every sampled value of the function
    xs = np.linspace(TRIG_LO, TRIG_HI, 2001).astype(np.float32)
    vals = getattr(np, fn)(xs.astype(np.float64))
    assert (vals >= got.lo.numpy() - 1e-6).all()
    assert (vals <= got.hi.numpy() + 1e-6).all()


def test_contains_width_and_iv():
    lo, hi = _boxes(2)
    ja, ta = _pair(lo, hi)
    x = torch.from_numpy(((lo + hi) / 2).astype(np.float32))
    np.testing.assert_array_equal(ta.contains(x).numpy(),
                                  np.asarray(ja.contains(jnp.asarray(x.numpy()))))
    np.testing.assert_array_equal(ta.contains(x + 10.0, tol=0.5).numpy(),
                                  np.zeros(lo.shape, bool))
    np.testing.assert_allclose(ta.width.numpy(), np.asarray(ja.width), rtol=TOL)
    point = iv(torch.from_numpy(lo))
    assert torch.equal(point.lo, point.hi)


def test_iv_dot_matches_jax():
    rng = np.random.default_rng(3)
    M = rng.normal(size=(4, 3)).astype(np.float32)
    lo = rng.normal(size=(9, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.1, 1.0, size=(9, 3)).astype(np.float32)
    want = jiv.iv_dot(jiv.IV(jnp.asarray(lo), jnp.asarray(hi)), jnp.asarray(M))
    got = iv_dot(IV(torch.from_numpy(lo), torch.from_numpy(hi)), torch.from_numpy(M))
    _close(got, want)


def test_iv_dot_sound_and_tight_for_linear_maps():
    """tests/test_control.py::test_iv_dot_sound_and_tight_for_linear_maps"""
    rng = np.random.default_rng(0)
    M = rng.normal(size=(4, 3)).astype(np.float32)
    lo = rng.normal(size=(5, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.1, 1.0, size=(5, 3)).astype(np.float32)
    out = iv_dot(IV(torch.from_numpy(lo), torch.from_numpy(hi)), torch.from_numpy(M))
    corners = np.stack([
        np.where(np.asarray(s, bool), hi, lo)
        for s in itertools.product([0, 1], repeat=3)
    ])  # (8, 5, 3)
    imgs = corners @ M.T  # (8, 5, 4)
    np.testing.assert_allclose(out.lo.numpy(), imgs.min(0), rtol=1e-5)
    np.testing.assert_allclose(out.hi.numpy(), imgs.max(0), rtol=1e-5)


def test_interval_dynamics_sound():
    """tests/test_control.py::test_interval_dynamics_sound"""
    sys = Segway()
    g = torch.Generator().manual_seed(0)
    c = torch.rand(16, 3, generator=g) - 0.5
    r = 0.05
    f_iv = sys.dynamics_interval(IV(c - r, c + r),
                                 IV(-torch.ones(16, 1), torch.ones(16, 1)))
    for i in range(50):
        x = c + (2 * torch.rand(c.shape, generator=g) - 1) * r
        u = 2 * torch.rand(16, 1, generator=g) - 1
        f = sys(x, u)
        assert bool(torch.all(f >= f_iv.lo - 1e-4)), i
        assert bool(torch.all(f <= f_iv.hi + 1e-4)), i
