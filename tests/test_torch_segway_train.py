"""The port's Segway training and certification
(fiode_tpu_torch/control/train_segway.py, certify_segway.py) against the
JAX package: one step of each training phase, the PGD on the states, a
short run fed the JAX run's initial weights and batches, resume, the two
packages certifying each other's controllers, and the committed float32
reference controller run_data/segway/segway_f32.npz against its JSON."""
import importlib
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fiode_tpu.attacks.pgd import pgd_attack as jax_pgd
from fiode_tpu.control import controllers as jctrl
from fiode_tpu.control import lyapunov_ctrl as jlya
from fiode_tpu.control import samplers as jsamp
from fiode_tpu.control.systems import Segway as JSegway
from fiode_tpu_torch.bridge import segway_from_numpy, segway_to_numpy
from fiode_tpu_torch.control import controllers as tctrl
from fiode_tpu_torch.control.lyapunov_ctrl import LyaQuadratic
from fiode_tpu_torch.control.systems import Segway

# the packages export functions under their modules' names
jcert = importlib.import_module("fiode_tpu.control.certify_segway")
jtrain = importlib.import_module("fiode_tpu.control.train_segway")
tcert = importlib.import_module("fiode_tpu_torch.control.certify_segway")
ttrain = importlib.import_module("fiode_tpu_torch.control.train_segway")

REF = Path(__file__).resolve().parents[1] / "run_data" / "segway"
TOL = 1e-5
P_TRAINED = np.array([[1.05, 0.12, -0.2], [0.12, 0.9, 0.15], [-0.2, 0.15, 0.85]],
                     np.float32)
SHORT = dict(fit_lqr_iters=6, barrier_iters=8, grid_r=0.3, batch_size=64,
             adv_train=False)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_draws(cfg, n_batches):
    """The JAX run's initial controller params and its phase-1 batches, from
    its own key chain."""
    key = jax.random.PRNGKey(cfg.seed)
    key, k_init = jax.random.split(key)
    params = jctrl.NNController.create(k_init, 3, 1, cfg.hidden).params
    sizes = jnp.asarray([cfg.phi_region, cfg.region, cfg.region])
    batches = []
    for _ in range(n_batches):
        key, k = jax.random.split(key)
        batches.append(np.asarray(jsamp.random_uniform(k, sizes, cfg.batch_size)))
    return _np_tree(params), batches


def _port_ctrl(params):
    return segway_from_numpy({"ctrl": params, "P": np.eye(3)}, "cpu")[0]


def _jax_vdot(params, eta):
    lya = jlya.LyaQuadratic(params["P"], jnp.zeros((1, 3)))
    u = jctrl.NNControllerModule(hidden=32).apply({"params": params["ctrl"]}, eta)
    return lya.h_dot(eta, JSegway()(eta, u))[:, 0]


def _jax_mask(P, eta, cfg):
    v = jlya.LyaQuadratic(P, jnp.zeros((1, 3)))(eta)[:, 0]
    return ((v >= cfg.level_lb) & (v <= cfg.level_ub)).astype(jnp.float32)


def _close_tree(port_ctrl, jax_ctrl_params, tol=TOL):
    got = segway_to_numpy(port_ctrl, torch.eye(3))["ctrl"]
    for layer in ("Dense_0", "Dense_1"):
        for leaf in ("kernel", "bias"):
            np.testing.assert_allclose(got[layer][leaf],
                                       np.asarray(jax_ctrl_params[layer][leaf]),
                                       rtol=tol, atol=tol, err_msg=f"{layer}/{leaf}")


# -- one step of each phase ------------------------------------------------------


def test_fit_step_matches_jax():
    cfg = ttrain.SegwayTrainConfig()
    params, (eta,) = _jax_draws(cfg, 1)
    K, _ = jctrl.lqr_gain(JSegway(), jnp.zeros((1, 3)), 10.0 * np.eye(3), np.eye(1))
    lqr = jctrl.LinearController(K)
    module = jctrl.NNControllerModule(hidden=cfg.hidden)
    mask = _jax_mask(jnp.eye(3), jnp.asarray(eta), cfg)

    def loss_fn(p):
        per = jnp.sum((module.apply({"params": p}, eta) - lqr(eta)) ** 2, axis=-1)
        return jnp.sum(per * mask) / jnp.maximum(jnp.sum(mask), 1.0)

    tx = optax.adam(cfg.lr_ctrl)
    jloss, jg = jax.value_and_grad(loss_fn)(params)
    up, _ = tx.update(jg, tx.init(params), params)
    jnew = optax.apply_updates(params, up)

    ctrl = _port_ctrl(params)
    tK, _ = tctrl.lqr_gain(Segway(), np.zeros((1, 3)), 10.0 * np.eye(3), np.eye(1))
    loss = ttrain._fit_loss(ctrl, tctrl.LinearController(tK), torch.from_numpy(eta), cfg)
    assert 0 < float(mask.sum()) < cfg.batch_size
    np.testing.assert_allclose(float(loss), float(jloss), rtol=TOL)
    opt = torch.optim.Adam(ctrl.parameters(), lr=cfg.lr_ctrl)
    loss.backward()
    grads = {f"Dense_{i}": {"kernel": getattr(ctrl, f"Dense_{i}").weight.grad.numpy().T,
                            "bias": getattr(ctrl, f"Dense_{i}").bias.grad.numpy()}
             for i in (0, 1)}
    for layer in grads:
        for leaf in grads[layer]:
            np.testing.assert_allclose(grads[layer][leaf], np.asarray(jg[layer][leaf]),
                                       rtol=TOL, atol=TOL)
    opt.step()
    _close_tree(ctrl, jnew)


def test_barrier_step_matches_jax():
    """Loss, gradients and two steps of the two-group Adam on the r = 0.1
    grid's band (optax.multi_transform of two optax.adam)."""
    cfg = ttrain.SegwayTrainConfig()
    params, _ = _jax_draws(cfg, 0)
    grid, *_ = jsamp.grid_uniform_3d(np.asarray([cfg.phi_region, cfg.region, cfg.region],
                                                np.float32), np.full(3, 0.1))
    jparams = {"ctrl": params, "P": jnp.asarray(P_TRAINED)}
    mask = _jax_mask(jparams["P"], jnp.asarray(grid), cfg)

    def loss_fn(p):
        return jnp.sum(jax.nn.relu(_jax_vdot(p, grid) + cfg.margin) * mask)

    tx = optax.multi_transform({"ctrl": optax.adam(cfg.lr_ctrl), "P": optax.adam(cfg.lr_P)},
                               {"ctrl": "ctrl", "P": "P"})
    opt_state = tx.init(jparams)
    jlosses, jgrads = [], []
    for _ in range(2):
        loss, g = jax.value_and_grad(loss_fn)(jparams)
        up, opt_state = tx.update(g, opt_state, jparams)
        jparams = optax.apply_updates(jparams, up)
        jlosses.append(float(loss))
        jgrads.append(g)

    ctrl = _port_ctrl(params)
    P = torch.nn.Parameter(torch.from_numpy(P_TRAINED.copy()))
    tmask = ttrain._band_mask(P.detach(), torch.from_numpy(grid), cfg)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(mask))
    assert 0 < float(tmask.sum()) < len(grid)
    opt = ttrain._barrier_adam(ctrl, P, cfg)
    for step in range(2):
        loss = ttrain._barrier_loss(ctrl, P, torch.from_numpy(grid), tmask, cfg)
        np.testing.assert_allclose(float(loss), jlosses[step], rtol=TOL)
        opt.zero_grad()
        loss.backward()
        np.testing.assert_allclose(P.grad.numpy(), np.asarray(jgrads[step]["P"]),
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(ctrl.Dense_0.weight.grad.numpy().T,
                                   np.asarray(jgrads[step]["ctrl"]["Dense_0"]["kernel"]),
                                   rtol=TOL, atol=TOL)
        opt.step()
    _close_tree(ctrl, jparams["ctrl"])
    np.testing.assert_allclose(P.detach().numpy(), np.asarray(jparams["P"]),
                               rtol=TOL, atol=TOL)


def test_pgd_on_the_states_matches_jax():
    cfg = ttrain.SegwayTrainConfig()
    params, _ = _jax_draws(cfg, 0)
    grid, *_ = jsamp.grid_uniform_3d(np.asarray([cfg.phi_region, cfg.region, cfg.region],
                                                np.float32), np.full(3, 0.1))
    jparams = {"ctrl": params, "P": jnp.asarray(P_TRAINED)}
    mask = _jax_mask(jparams["P"], jnp.asarray(grid), cfg)

    def adv_obj(eta):
        return jax.nn.relu(_jax_vdot(jparams, eta) + cfg.margin) * mask

    want = np.asarray(jax_pgd(adv_obj, jnp.asarray(grid), jax.random.PRNGKey(0),
                              eps=cfg.eps, norm="Linf", steps=7,
                              step_size=2.5 * cfg.eps / 7, rand_init=False,
                              clip_min=-2 * np.pi, clip_max=2 * np.pi))
    ctrl = _port_ctrl(params)
    got = ttrain._adversarial(ctrl, torch.from_numpy(P_TRAINED), torch.from_numpy(grid),
                              torch.from_numpy(np.asarray(mask)), cfg, None,
                              rand_init=False).numpy()
    # sign() flips where a gradient entry is zero up to round-off
    g = np.asarray(jax.grad(lambda e: jnp.sum(adv_obj(e)))(jnp.asarray(grid)))
    rows = (np.abs(g) > 1e-6).all(axis=1)
    assert rows.sum() > 100
    np.testing.assert_allclose(got[rows], want[rows], rtol=TOL, atol=TOL)
    idle = np.asarray(mask) == 0  # no gradient: the states stay
    np.testing.assert_array_equal(got[idle], grid[idle])
    assert np.abs(got - grid).max() <= cfg.eps + 1e-6


# -- whole runs ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_short():
    """The JAX package's short run (6 + 8 iterations, no PGD, r = 0.3 grid),
    its initial weights and batches, and its certificate at r = 0.1."""
    cfg = jtrain.SegwayTrainConfig(**SHORT)
    res = jtrain.train_segway(cfg, verbose=False)
    params, batches = _jax_draws(cfg, cfg.fit_lqr_iters)
    model = {"ctrl": _np_tree(res["ctrl"]), "P": np.asarray(res["P"]),
             "config": res["config"]}
    cert = jcert.certify_segway(model=model, r=0.1, simulate_trajectories=False,
                                verbose=False)
    return res, params, batches, model, cert


def test_short_run_matches_jax(jax_short, monkeypatch):
    """The port's train_segway fed the JAX run's initial weights and phase-1
    batches ends at the JAX run's best loss and parameters."""
    res, params, batches, _, _ = jax_short
    draws = iter(batches)
    monkeypatch.setattr(tctrl.NNController, "create",
                        classmethod(lambda cls, *a, **k: _port_ctrl(params)))
    monkeypatch.setattr(ttrain, "random_uniform",
                        lambda sizes, n, generator=None: torch.from_numpy(next(draws)))
    out = ttrain.train_segway(ttrain.SegwayTrainConfig(**SHORT), verbose=False,
                              device="cpu")
    assert next(draws, None) is None  # every batch drawn
    assert set(out) == set(res)
    np.testing.assert_allclose(out["best_loss"], res["best_loss"], rtol=TOL, atol=TOL)
    _close_tree(out["ctrl"], res["ctrl"])
    np.testing.assert_allclose(out["P"].numpy(), np.asarray(res["P"]), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(out["K_lqr"], res["K_lqr"], rtol=TOL)
    assert out["config"] == res["config"]


@pytest.mark.parametrize("kill", [dict(fit_lqr_iters=4, barrier_iters=0),
                                  dict(barrier_iters=4)], ids=["phase1", "phase2"])
def test_resume_replays_the_uninterrupted_run(tmp_path, kill):
    small = dict(fit_lqr_iters=6, barrier_iters=8, grid_r=0.3, batch_size=64,
                 adv_train=True, eps=0.01)
    full = ttrain.train_segway(ttrain.SegwayTrainConfig(**small), verbose=False,
                               device="cpu")
    p = str(tmp_path / "seg.npz")
    ttrain.train_segway(ttrain.SegwayTrainConfig(**{**small, **kill}), save_path=p,
                        verbose=False, checkpoint_every=4, device="cpu")
    resumed = ttrain.train_segway(ttrain.SegwayTrainConfig(**small), save_path=p,
                                  verbose=False, resume=True, checkpoint_every=4,
                                  device="cpu")
    assert resumed["best_loss"] == full["best_loss"]
    for a, b in zip(full["ctrl"].state_dict().values(),
                    resumed["ctrl"].state_dict().values()):
        assert torch.equal(a, b)
    assert torch.equal(full["P"], resumed["P"])
    saved = ttrain.load_segway(p, "cpu")
    assert torch.equal(saved["P"], resumed["P"])
    assert saved["best_loss"] == resumed["best_loss"]
    assert saved["config"] == resumed["config"]


def test_port_certifies_a_jax_trained_controller(jax_short):
    _, _, _, model, want = jax_short
    got = tcert.certify_segway(model=model, r=0.1, simulate_trajectories=False,
                               verbose=False, device="cpu")
    assert got.n_cells == want.n_cells > 0
    assert got.certified == want.certified
    np.testing.assert_allclose(got.ub_max, want.ub_max, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.exact_vdot_max, want.exact_vdot_max, rtol=TOL, atol=TOL)
    np.testing.assert_allclose([got.level_lb, got.level_ub],
                               [want.level_lb, want.level_ub], rtol=1e-12)


def test_jax_certifies_the_ports_npz(tmp_path):
    p = str(tmp_path / "port.npz")
    ttrain.train_segway(ttrain.SegwayTrainConfig(**SHORT), save_path=p, verbose=False,
                        device="cpu")
    m = ttrain.load_segway(p, "cpu")
    tree = {**segway_to_numpy(m["ctrl"], m["P"]), "config": m["config"]}
    want = jcert.certify_segway(model=tree, r=0.1, simulate_trajectories=False,
                                verbose=False)
    got = tcert.certify_segway(p, r=0.1, simulate_trajectories=False, verbose=False,
                               device="cpu")
    assert got.n_cells == want.n_cells > 0
    assert got.certified == want.certified
    np.testing.assert_allclose(got.ub_max, want.ub_max, rtol=TOL, atol=TOL)


# -- the committed float32 reference -------------------------------------------------


def _near_edge(lya, edges, r, sizes, ulps=2):
    """Grid states whose V lies within ``ulps`` float32 ulp of a band edge:
    two correct float32 evaluations of V may keep or drop them."""
    n = 0
    with torch.no_grad():
        for slab in tcert.grid_slabs(sizes, r, "cpu"):
            v = lya(slab)[:, 0]
            for e in edges:
                e32 = np.float32(e)
                n += int(((v - float(e32)).abs() <= ulps * float(np.spacing(e32))).sum())
    return n


def test_reference_controller_matches_the_json():
    ref = json.loads((REF / "segway_f32.json").read_text())
    want = ref["certify"]["0.01"]
    model = ttrain.load_segway(REF / "segway_f32.npz", "cpu")
    assert model["config"] == ref["config"]
    assert model["best_loss"] == ref["best_loss"]
    got = tcert.certify_segway(model=model, r=0.01, simulate_trajectories=False,
                               verbose=False, device="cpu")
    np.testing.assert_allclose([got.level_lb, got.level_ub],
                               [want["level_lb"], want["level_ub"]], atol=1e-6)
    if got.n_cells != want["n_cells"]:
        lya = LyaQuadratic(model["P"], torch.zeros(1, 3))
        slack = _near_edge(lya, (got.level_lb, got.level_ub), 0.01,
                           (float(np.pi / 12), 1.5, 1.5))
        assert abs(got.n_cells - want["n_cells"]) <= slack
    np.testing.assert_allclose(got.ub_max, want["ub_max"], atol=1e-4)
    np.testing.assert_allclose(got.exact_vdot_max, want["exact_vdot_max"], atol=1e-4)
    assert got.certified is False and want["certified"] is False
    sim = ref["simulate"]
    ts = np.linspace(*sim["ts"])
    xs, _ = Segway().simulate(torch.tensor(sim["x0"]), model["ctrl"], ts,
                              rtol=sim["rtol"], atol=sim["atol"])
    np.testing.assert_allclose(xs[-1].numpy(), sim["endpoint"], atol=1e-4)
