"""The port's attacks (fiode_tpu_torch.attacks) on the cheap differentiable
victim of tests/test_attacks.py: a linear classifier whose adversarial
behaviour is analytic.  Each attack stays in the ball and the box and breaks
what it should; the suite's composition invariants hold; APGD with the JAX
package's random start injected, and FAB (which draws nothing), return what
JAX returns.  One APGD-CE run goes through the port's ODE solve, and the
step-budget tracking of run_autoattack refuses a truncated solve (CPU)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fiode_tpu.attacks import apgd as japgd
from fiode_tpu.attacks.fab import fab_targeted as jax_fab
from fiode_tpu_torch.attacks import apgd as tapgd
from fiode_tpu_torch.attacks.apgd import (
    apgd_attack,
    apgd_ce,
    apgd_targeted,
    dlr_loss_targeted,
)
from fiode_tpu_torch.attacks.autoattack import AutoAttackSuite
from fiode_tpu_torch.attacks.fab import fab_targeted
from fiode_tpu_torch.attacks.pgd import pgd_attack
from fiode_tpu_torch.attacks.square import square_attack
from fiode_tpu_torch.experiment import BudgetedForward, run_autoattack
from fiode_tpu_torch.models.backbones import TinyMLPBackbone
from fiode_tpu_torch.models.dynamics import SimplexDynamics
from fiode_tpu_torch.models.ivp import NeuralODEClassifier

B, N_CLS, SHAPE = 16, 5, (3, 8, 8)
# float32 round-off of the two frameworks' norms and softmaxes over n_iter
# iterates of the same deterministic trajectory
PARITY_TOL = 1e-5
BALL_SLACK = 1e-5


@pytest.fixture(scope="module")
def victim():
    rng = np.random.default_rng(0)
    d = int(np.prod(SHAPE))
    W = (rng.normal(size=(N_CLS, d)) / np.sqrt(d)).astype(np.float32)
    x = rng.uniform(size=(B,) + SHAPE).astype(np.float32)
    y = (x.reshape(B, -1) @ W.T).argmax(-1)
    Wt = torch.from_numpy(W)

    def logits_fn(xa):
        return xa.reshape(xa.shape[0], -1) @ Wt.T

    Wj = jnp.asarray(W)

    def jax_logits(xa):
        return xa.reshape(xa.shape[0], -1) @ Wj.T

    return logits_fn, jax_logits, x, y


def _t(a):
    return torch.from_numpy(np.array(a))


def _acc(logits_fn, x, y):
    return float((logits_fn(x).argmax(-1) == y).float().mean())


def _l2(d):
    return torch.linalg.norm(d.reshape(d.shape[0], -1), dim=-1)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_pgd_linf_ball_and_effect(victim):
    logits_fn, _, x, y = victim
    x, y = _t(x), _t(y)
    eps = 0.1

    def ce(xa):
        return tapgd.ce_loss(logits_fn(xa), y)

    xa = pgd_attack(ce, x, eps=eps, norm="Linf", steps=10, generator=_gen(2))
    assert (xa - x).abs().max() <= eps + BALL_SLACK
    assert xa.min() >= 0 and xa.max() <= 1
    assert _acc(logits_fn, xa, y) < _acc(logits_fn, x, y)


def test_pgd_l2_ball(victim):
    logits_fn, _, x, y = victim
    x, y = _t(x), _t(y)

    def ce(xa):
        return tapgd.ce_loss(logits_fn(xa), y)

    xa = pgd_attack(ce, x, eps=1.0, norm="L2", steps=10, generator=_gen(3))
    assert _l2(xa - x).max() <= 1.0 + 1e-4
    assert xa.min() >= 0 and xa.max() <= 1


def test_apgd_ce_breaks_linear_victim(victim):
    logits_fn, _, x, y = victim
    x, y = _t(x), _t(y)
    xa, succ = apgd_ce(logits_fn, x, y, eps=2.0, norm="L2", n_iter=30,
                       generator=_gen(4))
    assert _l2(xa - x).max() <= 2.0 + 1e-3
    assert xa.min() >= 0 and xa.max() <= 1
    # an L2 ball of radius 2 is huge for this victim: most should break
    assert float(succ.float().mean()) > 0.5
    assert (logits_fn(xa).argmax(-1)[succ] != y[succ]).all()


def test_apgd_targeted_runs(victim):
    logits_fn, _, x, y = victim
    x, y = _t(x), _t(y)
    xa, succ = apgd_targeted(logits_fn, x, y, eps=2.0, norm="L2", n_iter=20,
                             n_target_classes=3, generator=_gen(5))
    assert xa.shape == x.shape
    assert _l2(xa - x).max() <= 2.0 + 1e-3
    assert float(succ.float().mean()) > 0.3


def test_dlr_loss_values():
    logits = torch.tensor([[4.0, 3.0, 2.0, 1.0, 0.0]])
    v = float(dlr_loss_targeted(logits, torch.tensor([0]), torch.tensor([1]))[0])
    # -(z_y - z_t) / (z_p1 - (z_p3 + z_p4) / 2) = -(4 - 3) / (4 - 1.5)
    assert v == pytest.approx(-1.0 / 2.5)
    with pytest.raises(ValueError, match="4 classes"):
        dlr_loss_targeted(logits[:, :3], torch.tensor([0]), torch.tensor([1]))


def test_square_linf(victim):
    logits_fn, _, x, y = victim
    x, y = _t(x), _t(y)
    xa, succ = square_attack(logits_fn, x, y, eps=0.2, norm="Linf",
                             n_queries=300, generator=_gen(6))
    assert (xa - x).abs().max() <= 0.2 + BALL_SLACK
    assert xa.min() >= 0 and xa.max() <= 1
    assert float(succ.float().mean()) > 0.2


def test_square_l2_stays_in_ball(victim):
    logits_fn, _, x, y = victim
    x, y = _t(x), _t(y)
    xa, succ = square_attack(logits_fn, x, y, eps=0.5, norm="L2",
                             n_queries=70, generator=_gen(11))
    assert _l2(xa - x).max() <= 0.5 + 1e-4
    assert xa.min() >= 0 and xa.max() <= 1
    assert (logits_fn(xa).argmax(-1)[succ] != y[succ]).all()


def test_fab_finds_small_perturbations(victim):
    logits_fn, _, x, y = victim
    x, y = _t(x), _t(y)
    xa, succ = fab_targeted(logits_fn, x, y, eps=3.0, norm="L2", n_iter=20,
                            n_target_classes=2)
    assert float(succ.float().mean()) > 0.5
    # successful ones are actually misclassified, within the ball
    assert (logits_fn(xa).argmax(-1)[succ] != y[succ]).all()
    assert _l2(xa - x)[succ].max() <= 3.0


def test_standard_composition(victim):
    logits_fn, _, x, y = victim
    x, y = _t(x), _t(y)
    suite = AutoAttackSuite(logits_fn, eps=1.5, norm="L2", n_iter=15,
                            square_queries=100)
    xa, robust = suite.run(x, y, _gen(8))
    pred = logits_fn(xa).argmax(-1)
    # every non-robust example has a working adversarial stored
    assert (pred[~robust] != y[~robust]).all()
    # robust ones were not modified
    assert (_l2(xa - x)[robust] == 0).all()
    assert _l2(xa - x).max() <= 1.5 * (1 + 1e-5)
    assert set(suite.seconds) == {"apgd-ce", "apgd-t", "fab-t", "square"}


def _jax_apgd_start(x, eps, key):
    """The start JAX's apgd_attack draws from ``key`` (L2)."""
    k_dir, k_rad = jax.random.split(key)
    d = japgd._normalize_grad(jax.random.normal(k_dir, x.shape), "L2")
    return d * eps * jax.random.uniform(k_rad, (x.shape[0], 1, 1, 1))


@pytest.mark.parametrize("loss", ["ce", "dlr-targeted"])
def test_apgd_with_jax_start_matches_jax(victim, monkeypatch, loss):
    logits_fn, jax_logits, x, y = victim
    eps, n_iter, key = 0.5, 30, jax.random.PRNGKey(12)
    y_t = (y + 1) % N_CLS if loss == "dlr-targeted" else None
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    want_x, want_f = jax.jit(lambda x_, k: japgd.apgd_attack(
        jax_logits, x_, jy, k, eps=eps, norm="L2", n_iter=n_iter, loss=loss,
        y_target=None if y_t is None else jnp.asarray(y_t)))(jx, key)
    delta = _t(_jax_apgd_start(jx, eps, key))
    monkeypatch.setattr(tapgd, "apgd_random_start",
                        lambda x_, eps_, norm_, gen_: delta)
    got_x, got_f = apgd_attack(
        logits_fn, _t(x), _t(y), eps=eps, norm="L2", n_iter=n_iter,
        loss=loss, y_target=None if y_t is None else _t(y_t))
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x),
                               atol=PARITY_TOL)
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f),
                               atol=PARITY_TOL)


def test_fab_matches_jax(victim):
    logits_fn, jax_logits, x, y = victim
    kw = dict(eps=3.0, norm="L2", n_iter=20, n_target_classes=2)
    want_x, want_s = jax.jit(lambda x_: jax_fab(
        jax_logits, x_, jnp.asarray(y), jax.random.PRNGKey(7), **kw))(
        jnp.asarray(x))
    got_x, got_s = fab_targeted(logits_fn, _t(x), _t(y), **kw)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x),
                               atol=PARITY_TOL)


def _tiny_ode_model(max_steps=64, t_max=0.5):
    g = torch.Generator().manual_seed(0)
    model = NeuralODEClassifier(
        TinyMLPBackbone(64, out_dim=10, hidden=16, mu=(0.5,), std=(0.25,),
                        generator=g),
        SimplexDynamics(n_hidden=10, mlp_size=32, x_dim=10, dropout=0.0,
                        scale_nominal=False, generator=g),
        t_max=t_max, max_steps=max_steps)
    return model.eval()


def test_apgd_ce_through_the_solve_returns_valid_adversarials():
    model = _tiny_ode_model()
    x = torch.rand(6, 1, 8, 8, generator=_gen(1))
    with torch.no_grad():
        y = model.predict(x).argmax(-1)
    forward = BudgetedForward(model)
    eps = 1.0
    xa, succ = apgd_ce(forward, x, y, eps=eps, norm="L2", n_iter=8,
                       generator=_gen(2))
    assert torch.isfinite(xa).all()
    assert _l2(xa - x).max() <= eps * (1 + 1e-5)
    assert xa.min() >= 0 and xa.max() <= 1
    with torch.no_grad():
        pred = model.predict(xa).argmax(-1)
    assert (pred[succ] != y[succ]).all()
    # the 8 iterations and the evaluations all went through the solve
    assert forward.forwards >= 8
    assert 0 < forward.max_attempts < model.max_steps


def test_step_budget_tracking_raises():
    x = torch.rand(4, 1, 8, 8, generator=_gen(3))
    model = _tiny_ode_model(max_steps=2, t_max=5.0)
    with pytest.raises(RuntimeError, match="max_steps"):
        BudgetedForward(model)(x)
    with pytest.raises(RuntimeError, match="max_steps"):
        run_autoattack(model, x, torch.zeros(4, dtype=torch.long), eps=0.5,
                       attacks=("apgd-ce",), n_iter=2)
    # run_autoattack restores the parameters' requires_grad flags
    assert all(p.requires_grad for p in model.parameters())


def test_run_autoattack_summary():
    model = _tiny_ode_model()
    x = torch.rand(6, 1, 8, 8, generator=_gen(4))
    with torch.no_grad():
        y = model.predict(x).argmax(-1)
    summary, xa = run_autoattack(model, x, y, eps=0.5,
                                 attacks=("apgd-ce", "square"), n_iter=4,
                                 square_queries=5, batch_size=4)
    assert xa.shape == x.shape and torch.isfinite(xa).all()
    assert summary["n_images"] == 6
    assert summary["robust_acc"] == len(summary["robust_idx"]) / 6
    assert 0 < summary["probe_attempts"] <= summary["max_attempts"] < 64
    assert set(summary["attack_seconds"]) == {"apgd-ce", "square"}
    robust = torch.zeros(6, dtype=torch.bool)
    robust[summary["robust_idx"]] = True
    assert (_l2(xa - x)[robust] == 0).all()
    with torch.no_grad():
        pred = model.predict(xa).argmax(-1)
    assert (pred[~robust] != y[~robust]).all()
