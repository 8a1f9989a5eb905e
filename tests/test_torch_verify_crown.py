"""Port parity: CROWN / IBP bounds (fiode_tpu_torch.verify.crown) against
the JAX package on the same numpy inputs (CPU, float32).

All three branches of ``_backward_from`` are held: layer 1 (exact affine),
the layer-2 sum / difference fast path (taken when out_dim >= the eta
width) and the general sign-split path (the last layer, and a second layer
narrower than eta), each with a scalar and a per-row per-dim eps, with and
without alpha overrides.  PARITY_TOL = 1e-5: float32 round-off of the same
products summed in two frameworks' orders, on bounds of size O(1).
Soundness is held by sampling, and CROWN lies within IBP.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fiode_tpu.verify import crown as jcrown
from fiode_tpu_torch.verify import crown as tcrown

PARITY_TOL = 1e-5
SOUND_TOL = 1e-4
N_CELLS = 24


def _mlp(seed, n, m1, m2):
    rng = np.random.default_rng(seed)
    Ws = [0.5 * rng.normal(size=(m1, n)),
          0.5 * rng.normal(size=(m2, m1)) / np.sqrt(m1),
          0.5 * rng.normal(size=(n, m2)) / np.sqrt(m2)]
    bs = [0.1 * rng.normal(size=(m1,)), 0.1 * rng.normal(size=(m2,)),
          0.1 * rng.normal(size=(n,))]
    x_bias = rng.normal(size=(N_CELLS, m1))
    eta0 = rng.uniform(size=(N_CELLS, n))
    eta0 /= eta0.sum(-1, keepdims=True)
    eps_rows = rng.uniform(0.01, 0.08, size=(N_CELLS, n))
    alphas = [rng.uniform(-0.2, 1.2, size=(N_CELLS, m1)),
              rng.uniform(-0.2, 1.2, size=(N_CELLS, m2))]
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return ([f32(W) for W in Ws], [f32(b) for b in bs], f32(x_bias),
            f32(eta0), f32(eps_rows), [f32(a) for a in alphas])


# (n, m1, m2): "fast" takes the layer-2 fast path (m2 >= n); "general" a
# second layer narrower than eta, so layer 2 takes the sign-split path too
SHAPES = {"fast": (6, 16, 16), "general": (6, 16, 4)}


def _both(fn_name, Ws, bs, eta0, eps, x_bias, alphas=None):
    jargs = ([jnp.asarray(W) for W in Ws], [jnp.asarray(b) for b in bs],
             jnp.asarray(eta0),
             eps if np.ndim(eps) == 0 else jnp.asarray(eps),
             jnp.asarray(x_bias))
    targs = ([torch.from_numpy(W) for W in Ws],
             [torch.from_numpy(b) for b in bs], torch.from_numpy(eta0),
             eps if np.ndim(eps) == 0 else torch.from_numpy(eps),
             torch.from_numpy(x_bias))
    if alphas is not None:
        jargs += ([jnp.asarray(a) for a in alphas],)
        targs += ([torch.from_numpy(a) for a in alphas],)
    want = getattr(jcrown, fn_name)(*jargs)
    got = getattr(tcrown, fn_name)(*targs)
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


def _forward(Ws, bs, x_bias, eta):
    z = np.maximum(eta @ Ws[0].T + bs[0] + x_bias, 0.0)
    z = np.maximum(z @ Ws[1].T + bs[1], 0.0)
    return z @ Ws[2].T + bs[2]


@pytest.mark.parametrize("with_alphas", [False, True])
@pytest.mark.parametrize("eps_kind", ["scalar", "per_dim"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_crown_bounds_match_jax(shape, eps_kind, with_alphas):
    Ws, bs, x_bias, eta0, eps_rows, alphas = _mlp(0, *SHAPES[shape])
    eps = 0.05 if eps_kind == "scalar" else eps_rows
    got, want = _both("crown_mlp_bounds", Ws, bs, eta0, eps, x_bias,
                      alphas if with_alphas else None)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=PARITY_TOL)
    assert (got[0] <= got[1] + 1e-6).all()


@pytest.mark.parametrize("eps_kind", ["scalar", "per_dim"])
@pytest.mark.parametrize("layer", [1, 2, 3])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_backward_from_each_layer_matches_jax(shape, layer, eps_kind):
    Ws, bs, x_bias, eta0, eps_rows, _ = _mlp(1, *SHAPES[shape])
    eps = 0.04 if eps_kind == "scalar" else eps_rows
    jW, jb = [jnp.asarray(W) for W in Ws], [jnp.asarray(b) for b in bs]
    tW, tb = [torch.from_numpy(W) for W in Ws], [torch.from_numpy(b) for b in bs]
    jeps = eps if eps_kind == "scalar" else jnp.asarray(eps)
    teps = eps if eps_kind == "scalar" else torch.from_numpy(eps)
    jrelax, trelax = [], []
    for j in range(1, layer + 1):
        want = jcrown._backward_from(j, jW, jb, jrelax, jnp.asarray(eta0),
                                     jeps, jnp.asarray(x_bias))
        got = tcrown._backward_from(j, tW, tb, trelax,
                                    torch.from_numpy(eta0), teps,
                                    torch.from_numpy(x_bias))
        jr = jcrown.relu_relaxation(*want)
        tr = tcrown.relu_relaxation(*got)
        for a, b in zip(tr, jr):
            # slopes of an unstable neuron divide by u - l
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)
        jrelax.append(jr)
        trelax.append(tr)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=PARITY_TOL)


@pytest.mark.parametrize("eps_kind", ["scalar", "per_dim"])
def test_ibp_bounds_match_jax_and_contain_crown(eps_kind):
    Ws, bs, x_bias, eta0, eps_rows, _ = _mlp(2, *SHAPES["fast"])
    eps = 0.05 if eps_kind == "scalar" else eps_rows
    (il, iu), want = _both("ibp_mlp_bounds", Ws, bs, eta0, eps, x_bias)
    np.testing.assert_allclose(il, want[0], atol=PARITY_TOL)
    np.testing.assert_allclose(iu, want[1], atol=PARITY_TOL)
    (lb, ub), _ = _both("crown_mlp_bounds", Ws, bs, eta0, eps, x_bias)
    assert (lb >= il - SOUND_TOL).all() and (ub <= iu + SOUND_TOL).all()


@pytest.mark.parametrize("with_alphas", [False, True])
@pytest.mark.parametrize("eps_kind", ["scalar", "per_dim"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_bounds_contain_sampled_values(shape, eps_kind, with_alphas):
    Ws, bs, x_bias, eta0, eps_rows, alphas = _mlp(3, *SHAPES[shape])
    eps = 0.05 if eps_kind == "scalar" else eps_rows
    (lb, ub), _ = _both("crown_mlp_bounds", Ws, bs, eta0, eps, x_bias,
                        alphas if with_alphas else None)
    rng = np.random.default_rng(4)
    gap = np.inf
    for _ in range(20):
        d = rng.uniform(-1.0, 1.0, size=eta0.shape).astype(np.float32) * eps
        f = _forward(Ws, bs, x_bias, eta0 + d)
        assert (f >= lb - SOUND_TOL).all(), "lower bound violated"
        assert (f <= ub + SOUND_TOL).all(), "upper bound violated"
        gap = min(gap, float((ub - f).min()))
    assert gap < 1.0  # not vacuous


def test_corner_values_tight_for_linear_net():
    Ws = [torch.eye(4)] * 3
    bs = [torch.full((4,), 5.0), torch.zeros(4), torch.zeros(4)]
    lb, ub = tcrown.crown_mlp_bounds(Ws, bs, torch.zeros(1, 4), 0.1,
                                     torch.zeros(4))
    np.testing.assert_allclose(ub.numpy()[0], 5.1, atol=1e-5)
    np.testing.assert_allclose(lb.numpy()[0], 4.9, atol=1e-5)


@pytest.mark.parametrize("objective", ["width", "upper"])
def test_optimized_alphas_match_jax_and_never_worse(objective):
    Ws, bs, x_bias, eta0, _, _ = _mlp(5, *SHAPES["fast"])
    eps = 0.08
    if objective == "width":
        jloss = lambda lb, ub: jnp.sum(ub - lb, -1)  # noqa: E731
        tloss = lambda lb, ub: (ub - lb).sum(-1)  # noqa: E731
    else:
        jloss = lambda lb, ub: jnp.max(ub, -1)  # noqa: E731
        tloss = lambda lb, ub: ub.amax(-1)  # noqa: E731
    jW, jb = [jnp.asarray(W) for W in Ws], [jnp.asarray(b) for b in bs]
    tW, tb = [torch.from_numpy(W) for W in Ws], [torch.from_numpy(b) for b in bs]
    want = jcrown.optimize_crown_alphas(
        jW, jb, jnp.asarray(eta0), eps, jnp.asarray(x_bias), loss_fn=jloss,
        iters=4)
    with torch.no_grad():  # grad mode is switched on inside
        got = tcrown.optimize_crown_alphas(
            tW, tb, torch.from_numpy(eta0), eps, torch.from_numpy(x_bias),
            loss_fn=tloss, iters=4)
    assert all(not a.requires_grad for a in got)
    args = (tW, tb, torch.from_numpy(eta0), eps, torch.from_numpy(x_bias))
    loss0 = tloss(*tcrown.crown_mlp_bounds(*args))
    loss1 = tloss(*tcrown.crown_mlp_bounds(*args, got))
    # per cell never worse than iterate 0, and better somewhere
    assert (loss1 <= loss0 + 1e-6).all()
    assert (loss1 < loss0 - 1e-4).any()
    # the same objective value as the JAX iterates reach (signed steps: a
    # gradient of rounding size may take the other sign on a few neurons,
    # so the slopes are compared through the loss they give)
    jloss1 = jloss(*jcrown.crown_mlp_bounds(
        jW, jb, jnp.asarray(eta0), eps, jnp.asarray(x_bias), want))
    np.testing.assert_allclose(loss1.numpy(), np.asarray(jloss1), atol=1e-4)
    same = np.mean([np.mean(np.abs(a.numpy() - np.asarray(b)) < 1e-5)
                    for a, b in zip(got, want)])
    assert same > 0.99
    # sampled values stay inside the optimised bounds
    lb, ub = (t.numpy() for t in tcrown.crown_mlp_bounds(*args, got))
    rng = np.random.default_rng(6)
    for _ in range(10):
        d = rng.uniform(-eps, eps, size=eta0.shape).astype(np.float32)
        f = _forward(Ws, bs, x_bias, eta0 + d)
        assert (f >= lb - SOUND_TOL).all() and (f <= ub + SOUND_TOL).all()


def test_select_fn_scores_the_iterates():
    Ws, bs, x_bias, eta0, _, _ = _mlp(7, *SHAPES["fast"])
    args = ([torch.from_numpy(W) for W in Ws],
            [torch.from_numpy(b) for b in bs], torch.from_numpy(eta0), 0.08,
            torch.from_numpy(x_bias))
    select = lambda lb, ub: ub.amax(-1)  # noqa: E731
    got = tcrown.optimize_crown_alphas(
        *args, loss_fn=lambda lb, ub: (ub - lb).sum(-1), iters=4,
        select_fn=select)
    s0 = select(*tcrown.crown_mlp_bounds(*args))
    s1 = select(*tcrown.crown_mlp_bounds(*args, got))
    assert (s1 <= s0 + 1e-6).all()
