"""The port's Segway plant, controllers, Lyapunov / barrier functions,
samplers, simulation and cell bounds (fiode_tpu_torch/control/) against the
JAX package's on the same numpy inputs."""
import importlib
import inspect
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fiode_tpu.control import controllers as jctrl
from fiode_tpu.control import lyapunov_ctrl as jlya
from fiode_tpu.control import samplers as jsamp
from fiode_tpu.control.systems import Segway as JSegway
from fiode_tpu.verify.interval import IV as JIV
from fiode_tpu_torch.bridge import _flatten, segway_from_numpy, segway_to_numpy
from fiode_tpu_torch.control import controllers as tctrl
from fiode_tpu_torch.control import lyapunov_ctrl as tlya
from fiode_tpu_torch.control import samplers as tsamp
from fiode_tpu_torch.control.systems import Segway
from fiode_tpu_torch.verify.certify import float32_matmuls
from fiode_tpu_torch.verify.interval import IV

# the packages export functions under their modules' names
jcert = importlib.import_module("fiode_tpu.control.certify_segway")
tcert = importlib.import_module("fiode_tpu_torch.control.certify_segway")
ttrain = importlib.import_module("fiode_tpu_torch.control.train_segway")

TOL = 1e-6
MIXED_P = np.array([[1.2, -0.7, 0.3], [0.0, 0.9, -0.5], [0.2, 0.1, 1.1]],
                   np.float32)


def _states(seed, n=64, scale=(0.3, 1.5, 1.5)):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, size=(n, 3)) * np.array(scale)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _jax_ctrl(seed, hidden=8):
    """A JAX NNController and the port's copy through the bridge."""
    jc = jctrl.NNController.create(jax.random.PRNGKey(seed), 3, 1, hidden)
    tree = {"ctrl": jax.tree_util.tree_map(np.asarray, jc.params),
            "P": np.eye(3, dtype=np.float32)}
    tc, _ = segway_from_numpy(tree, "cpu")
    return jc, tc, tree


# -- plant ---------------------------------------------------------------------


def test_segway_f_matches_jax():
    x = _states(0)
    u = np.random.default_rng(1).uniform(-3, 3, size=(64, 1)).astype(np.float32)
    want = np.asarray(JSegway()(jnp.asarray(x), jnp.asarray(u)))
    got = Segway()(_t(x), _t(u)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(Segway()(torch.zeros(1, 3), torch.zeros(1, 1)).numpy(),
                               0.0, atol=1e-6)


def test_segway_jacobian_matches_jax():
    x = _states(2, n=8)
    u = np.random.default_rng(3).uniform(-1, 1, size=(8, 1)).astype(np.float32)
    jA, jB = JSegway().jacobian(jnp.asarray(x), jnp.asarray(u))
    A, B = Segway().jacobian(_t(x), _t(u))
    assert A.shape == (8, 3, 3) and B.shape == (8, 3, 1)
    np.testing.assert_allclose(A.numpy(), np.asarray(jA), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(B.numpy(), np.asarray(jB), rtol=TOL, atol=TOL)
    eig = np.linalg.eigvals(Segway().jacobian(torch.zeros(1, 3), torch.zeros(1, 1))[0][0].numpy())
    assert eig.real.max() > 0.1, "the upright pendulum must be unstable"


def test_dynamics_interval_matches_jax():
    c = _states(4, n=32)
    u = np.random.default_rng(5).uniform(-2, 2, size=(32, 1)).astype(np.float32)
    r, ru = 0.05, 0.3
    want = JSegway().dynamics_interval(JIV(jnp.asarray(c - r), jnp.asarray(c + r)),
                                       JIV(jnp.asarray(u - ru), jnp.asarray(u + ru)))
    got = Segway().dynamics_interval(IV(_t(c - r), _t(c + r)), IV(_t(u - ru), _t(u + ru)))
    np.testing.assert_allclose(got.lo.numpy(), np.asarray(want.lo), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.hi.numpy(), np.asarray(want.hi), rtol=TOL, atol=TOL)


# -- controllers -----------------------------------------------------------------


def test_lqr_gain_matches_jax():
    Q, R = 10 * np.eye(3), np.eye(1)
    jK, jP = jctrl.lqr_gain(JSegway(), np.zeros(3), Q, R)
    K, P = tctrl.lqr_gain(Segway(), np.zeros(3), Q, R)
    assert K.dtype == P.dtype == np.float32
    np.testing.assert_allclose(K, jK, rtol=1e-5)
    np.testing.assert_allclose(P, jP, rtol=1e-5)


def test_constant_and_linear_controllers_match_jax():
    x = _states(6)
    K = np.array([[-30.0, -3.2, -8.5]], np.float32)
    np.testing.assert_allclose(tctrl.LinearController(K)(_t(x)).numpy(),
                               np.asarray(jctrl.LinearController(K)(jnp.asarray(x))),
                               rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(tctrl.ConstantController(0.3)(_t(x)).numpy(),
                                  np.asarray(jctrl.ConstantController(0.3)(jnp.asarray(x))))


def test_nn_controller_matches_jax_and_bridge_round_trips():
    jc, tc, tree = _jax_ctrl(0, hidden=16)
    x = _states(7)
    np.testing.assert_allclose(tc(_t(x)).detach().numpy(), np.asarray(jc(jnp.asarray(x))),
                               rtol=TOL, atol=TOL)
    Ws, bs = tc.dense_weights()
    jWs, jbs = jc.dense_weights()
    for a, b in zip(Ws + bs, jWs + jbs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    back = dict(_flatten(segway_to_numpy(tc, torch.eye(3))))
    want = dict(_flatten(tree))
    assert back.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(back[key], want[key])


def test_nn_controller_init_is_flax_dense_init():
    """lecun_normal kernels (truncated at two of their std), zero biases,
    from the caller's generator."""
    a = tctrl.NNController.create(torch.Generator().manual_seed(3), 3, 1, 512)
    b = tctrl.NNController.create(torch.Generator().manual_seed(3), 3, 1, 512)
    w = a.Dense_0.weight.detach()
    assert torch.equal(w, b.Dense_0.weight)
    std = np.sqrt(1.0 / 3) / 0.87962566103423978
    assert float(w.abs().max()) <= 2 * std
    assert abs(float(w.std()) - np.sqrt(1.0 / 3)) < 0.05
    assert float(a.Dense_0.bias.abs().max()) == 0.0 == float(a.Dense_1.bias.abs().max())
    assert tctrl.NNController().Dense_0.weight.abs().max() == 0  # no draw


# -- Lyapunov and barrier functions ----------------------------------------------


@pytest.mark.parametrize("P", [np.eye(3, dtype=np.float32), MIXED_P])
def test_lya_quadratic_matches_jax(P):
    x = _states(8)
    f = _states(9)
    jl = jlya.LyaQuadratic(jnp.asarray(P), jnp.zeros((1, 3)))
    tl = tlya.LyaQuadratic(_t(P), torch.zeros(1, 3))
    np.testing.assert_allclose(tl(_t(x)).numpy(), np.asarray(jl(jnp.asarray(x))),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tl.h_dot(_t(x), _t(f)).numpy(),
                               np.asarray(jl.h_dot(jnp.asarray(x), jnp.asarray(f))),
                               rtol=TOL, atol=TOL)
    assert tl.sigma_max() == jl.sigma_max()


@pytest.mark.parametrize("name,side", list(itertools.product(
    ["BarrierExt", "BarrierPhiV", "BarrierPhiDotV", "BarrierV"], ["lb", "ub"])))
def test_barriers_match_jax(name, side):
    x, f = _states(10), _states(11)
    jb = getattr(jlya, name)(alpha=1.5, alpha_ext=0.7, side=side)
    tb = getattr(tlya, name)(alpha=1.5, alpha_ext=0.7, side=side)
    for method in ("__call__", "h_dot"):
        np.testing.assert_allclose(
            getattr(tb, method)(_t(f), _t(x)).numpy(),
            np.asarray(getattr(jb, method)(jnp.asarray(f), jnp.asarray(x))),
            rtol=TOL, atol=TOL)


def test_barrier_models_match_jax():
    jc, tc, _ = _jax_ctrl(1)
    x = _states(12)
    names = ["BarrierExt", "BarrierPhiV", "BarrierPhiDotV", "BarrierV"]
    jm = jlya.SegwayCompositeBarrierModel(
        JSegway(), jc, [getattr(jlya, n)(1.0, 0.5, s) for n in names for s in ("lb", "ub")])
    tm = tlya.SegwayCompositeBarrierModel(
        Segway(), tc, [getattr(tlya, n)(1.0, 0.5, s) for n in names for s in ("lb", "ub")])
    with torch.no_grad():
        np.testing.assert_allclose(tm(_t(x)).numpy(), np.asarray(jm(jnp.asarray(x))),
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(tm.forward_adv(_t(x)).numpy(),
                                   np.asarray(jm.forward_adv(jnp.asarray(x))),
                                   rtol=TOL, atol=TOL)
        js = jlya.SegwaySingleBarrierModel(
            JSegway(), jc, jlya.LyaQuadratic(jnp.asarray(MIXED_P), jnp.zeros((1, 3))))
        ts = tlya.SegwaySingleBarrierModel(
            Segway(), tc, tlya.LyaQuadratic(_t(MIXED_P), torch.zeros(1, 3)))
        np.testing.assert_allclose(ts(_t(x)).numpy(), np.asarray(js(jnp.asarray(x))),
                                   rtol=TOL, atol=TOL)


# -- samplers ----------------------------------------------------------------------


@pytest.mark.parametrize("dim", [2, 3, 4])
def test_grids_bit_equal(dim):
    sizes = np.array([0.5, 1.0, 0.7, 0.3][:dim])
    r = np.array([0.1, 0.25, 0.2, 0.15][:dim])
    got = getattr(tsamp, f"grid_uniform_{dim}d")(sizes, r)
    want = getattr(jsamp, f"grid_uniform_{dim}d")(sizes, r)
    assert len(got) == len(want) == dim + 1
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name,side", list(itertools.product(
    ["SamplingPhiPhiDot", "SamplingPhiV", "SamplingPhiDotV", "SamplingV"], ["lb", "ub"])))
def test_face_samplers_bit_equal(name, side):
    args = ([10.0, 0.1, 2.0], [0.02, 0.05, 0.05], side)
    got, got_rs = getattr(tsamp, name)(*args)()
    want, want_rs = getattr(jsamp, name)(*args)()
    assert got_rs == want_rs
    if want is None:
        assert got is None
    else:
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(tsamp._face_mask(got, args[0]),
                                      jsamp._face_mask(want, args[0]))


def test_random_samplers_in_their_sets():
    """The random samplers by membership, as
    tests/test_control.py::test_polytope_sampler_in_polytope does."""
    g = torch.Generator().manual_seed(1)
    sizes = torch.tensor([np.pi / 12, 1.5, 1.5])
    u = tsamp.random_uniform(sizes, 4096, generator=g)
    assert u.shape == (4096, 3) and (u.abs() <= sizes).all()
    assert (u.abs().amax(0) > 0.95 * sizes).all()
    for fn in (tsamp.random_polytope, tsamp.random_polytope_clipv):
        eta = fn(torch.tensor([np.pi / 12]), 256, generator=g).numpy()
        phi, v, phi_dot = eta[:, 0], eta[:, 1], eta[:, 2]
        assert (np.abs(phi) <= np.pi / 12 + 1e-6).all()
        assert (phi_dot <= -10.0 * (phi - np.pi / 12) + 1e-4).all()
        assert (phi_dot >= -10.0 * (phi + np.pi / 12) - 1e-4).all()
        assert (phi_dot <= -2.0 * (v - 2.25) + 1e-4).all()
        if fn is tsamp.random_polytope_clipv:
            assert (np.abs(v) <= 2.5 + 1e-6).all()
    ext = tsamp.random_uniform_extend(sizes, 512, alpha_1=2.0, generator=g)
    phi, phi_dot = ext[:, 2], ext[:, 3]
    assert ext.shape == (512, 4)
    assert (phi_dot <= 2.0 * (np.pi / 12 - phi) + 1e-5).all()
    assert (phi_dot >= -2.0 * (np.pi / 12 + phi) - 1e-5).all()
    again = tsamp.random_uniform(sizes, 4096, generator=torch.Generator().manual_seed(1))
    assert torch.equal(u, again)


def test_reject_sampling_matches_jax():
    g, *_ = jsamp.grid_uniform_3d(np.array([0.5, 0.5, 0.5]), np.full(3, 0.1))
    jl = jlya.LyaQuadratic(jnp.asarray(MIXED_P), jnp.zeros((1, 3)))
    tl = tlya.LyaQuadratic(_t(MIXED_P), torch.zeros(1, 3))
    want, wmask = jsamp.reject_sampling(g, jl, 0.1, 0.2, return_mask=True)
    got, mask = tsamp.reject_sampling(g, tl, 0.1, 0.2, return_mask=True)
    assert 0 < len(want) < len(g)
    np.testing.assert_array_equal(mask.numpy(), wmask)
    np.testing.assert_array_equal(got.numpy(), want)


# -- simulation --------------------------------------------------------------------


def test_simulate_lqr_loop_matches_jax():
    K, _ = tctrl.lqr_gain(Segway(), np.zeros(3), 10 * np.eye(3), np.eye(1))
    x0 = np.array([[0.1, 0.2, -0.1], [-0.2, 0.5, 0.3]], np.float32)
    ts = np.linspace(0, 8, 20)
    jxs, jus = JSegway().simulate(jnp.asarray(x0), jctrl.LinearController(K), ts)
    xs, us = Segway().simulate(_t(x0), tctrl.LinearController(K), ts)
    assert xs.shape == (20, 2, 3) and us.shape == (20, 2, 1)
    np.testing.assert_allclose(xs.numpy(), np.asarray(jxs), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(us.numpy(), np.asarray(jus), rtol=1e-5, atol=1e-5)
    assert np.abs(xs[-1].numpy()).max() < 1e-2


def test_simulate_raises_at_max_steps():
    K, _ = tctrl.lqr_gain(Segway(), np.zeros(3), 10 * np.eye(3), np.eye(1))
    x0 = torch.tensor([[0.1, 0.2, -0.1]])
    with pytest.raises(RuntimeError, match="max_steps"):
        Segway().simulate(x0, tctrl.LinearController(K), np.linspace(0, 8, 20),
                          max_steps=10)
    with pytest.raises(ValueError, match="step_size"):
        Segway().simulate(x0, tctrl.LinearController(K), [0.0, 1.0], method="rk4")


# -- certification -----------------------------------------------------------------


@pytest.mark.parametrize("P,hw", [(np.eye(3, dtype=np.float32), 0.01), (MIXED_P, 0.05)])
def test_vdot_cell_bounds_match_jax(P, hw):
    jc, tc, _ = _jax_ctrl(7)
    cells = np.random.default_rng(8).uniform(-0.3, 0.3, size=(64, 3)).astype(np.float32)
    jWs, jbs = jc.dense_weights()
    jlb, jub = jcert.vdot_cell_bounds(JSegway(), jWs, jbs, jnp.asarray(P),
                                      jnp.asarray(cells), hw)
    Ws, bs = tc.dense_weights()
    with torch.no_grad(), float32_matmuls():
        lb, ub = tcert.vdot_cell_bounds(Segway(), Ws, bs, _t(P), _t(cells), hw)
    np.testing.assert_allclose(lb.numpy(), np.asarray(jlb), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ub.numpy(), np.asarray(jub), rtol=1e-5, atol=1e-5)
    # and the bound holds at every corner of every cell
    lya = tlya.LyaQuadratic(_t(P), torch.zeros(1, 3))
    with torch.no_grad():
        for signs in itertools.product([-1.0, 1.0], repeat=3):
            x = _t(cells) + hw * torch.tensor(signs)
            vd = lya.h_dot(x, Segway()(x, tc(x)))[:, 0]
            assert bool(torch.all(vd <= ub + 1e-4)) and bool(torch.all(vd >= lb - 1e-4))


def test_band_cells_are_the_jax_grid_cells():
    jl = jlya.LyaQuadratic(jnp.asarray(MIXED_P), jnp.zeros((1, 3)))
    tl = tlya.LyaQuadratic(_t(MIXED_P), torch.zeros(1, 3))
    sizes, r = (float(np.pi / 12), 1.5, 1.5), 0.05
    grid, *_ = jsamp.grid_uniform_3d(np.asarray(sizes), np.full(3, r))
    want = jsamp.reject_sampling(grid, jl, 0.12, 0.18)
    got = tcert.band_cells(tl, 0.12, 0.18, r, sizes)
    np.testing.assert_array_equal(got.numpy(), want)
    saved = tcert.SLAB_STATES
    try:  # slabs of one v value each: the same cells in the same order
        tcert.SLAB_STATES = 1
        np.testing.assert_array_equal(tcert.band_cells(tl, 0.12, 0.18, r, sizes).numpy(), want)
    finally:
        tcert.SLAB_STATES = saved


def test_certify_refuses_plots_empty_bands_and_defaults_to_the_card():
    _, tc, _ = _jax_ctrl(2)
    model = {"ctrl": tc, "P": torch.eye(3)}
    with pytest.raises(NotImplementedError, match="Slice F"):
        tcert.certify_segway(model=model, plot_dir="plots", device="cpu")
    with pytest.raises(ValueError, match="no grid cell"):
        tcert.certify_segway(model=model, level=1e-9, r=0.3, device="cpu",
                             simulate_trajectories=False, verbose=False)
    for fn in (tcert.certify_segway, ttrain.train_segway):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():  # no silent fall-back to the CPU
        with pytest.raises((RuntimeError, AssertionError)):
            tcert.certify_segway(model=model, r=0.3, verbose=False)
