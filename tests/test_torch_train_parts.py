"""The parts of the port's training stack against the JAX package, on the
same inputs: the Lyapunov candidates, kappa schedules and loss; each sampler
and the crop-and-flip augmentation given the base draws JAX's own calls
made; the composite sampler's slot owners; the sampler schedulers; the
backbone Lipschitz estimate; and config composition (with the port's YAML
reader against PyYAML) for every file under configs/.

Tolerances: candidates, loss, metrics and the loss's gradient in f 1e-6
(float32 round-off of the two frameworks' reductions); samplers and
augmentation 1e-7 (the same float32 operations on the same draws; the
softmax-based ones may differ in their last bits); slot owners, schedulers
and configs exact; the Lipschitz estimate 1e-5 relative.
"""
import glob
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from fiode_tpu.models.backbones import PlainCNNBackbone as JaxPlainCNN
from fiode_tpu.train import lyapunov as jly
from fiode_tpu.train import samplers as jsamp
from fiode_tpu.train import schedulers as jsch
from fiode_tpu.train.data import augment_batch as jax_augment
from fiode_tpu.train.lips import compute_lfx as jax_compute_lfx
from fiode_tpu.train.lips import lfx_init as jax_lfx_init
from fiode_tpu.utils import config as jcfg
from fiode_tpu_torch.bridge import params_from_numpy
from fiode_tpu_torch.models.backbones import PlainCNNBackbone
from fiode_tpu_torch.train import lyapunov as tly
from fiode_tpu_torch.train import samplers as tsamp
from fiode_tpu_torch.train import schedulers as tsch
from fiode_tpu_torch.train.data import augment_batch
from fiode_tpu_torch.train.lips import compute_lfx, lfx_init
from fiode_tpu_torch.utils import config as tcfg

REPO = Path(__file__).resolve().parents[1]
CANDIDATES = ["DynCrossEntropy", "MSELoss", "OnemEtay",
              "CompositeDynCrossEntropy", "DecisionBoundary"]
N = 10


def _t(a):
    return torch.from_numpy(np.array(a))


def _states(seed=0, rows=48):
    """(h, f, y): simplex rows, a third of them on exact decision-boundary
    ties (p_y = max wrong) and one with two tied wrong maxima, tangents and
    labels."""
    rng = np.random.default_rng(seed)
    h = rng.exponential(size=(rows, N)).astype(np.float32)
    y = rng.integers(0, N, rows).astype(np.int32)
    for r in range(0, rows, 3):
        j = (y[r] + 1) % N
        h[r, y[r]] = h[r, j] = h[r].max()
    h[1, :] = [0.4, 0.4, 0.2] + [0.0] * (N - 3)
    y[1] = 2
    h = h / h.sum(-1, keepdims=True)
    f = rng.normal(size=(rows, N)).astype(np.float32)
    f -= f.mean(-1, keepdims=True)
    return h, f, y


@pytest.mark.parametrize("name", CANDIDATES)
def test_candidates_match_jax(name):
    h, f, y = _states()
    jv, jvdot = jax.jvp(lambda p: jly.get_lya_candidate(name, N)(p, jnp.asarray(y)),
                        (jnp.asarray(h),), (jnp.asarray(f),))
    cand = tly.get_lya_candidate(name, N)
    tv, tvdot = torch.func.jvp(lambda p: cand(p, _t(y).long()), (_t(h),), (_t(f),))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tvdot.numpy(), np.asarray(jvdot), rtol=0, atol=1e-6)


def test_decision_boundary_tie_averages_the_tied_slopes():
    """jnp.max's derivative averages tied maxima: p = (0.4, 0.4, 0.2),
    label 2, tangent (1, 3, 0) gives Vdot = 2.0."""
    p = torch.tensor([[0.4, 0.4, 0.2]])
    _, vdot = torch.func.jvp(
        lambda q: tly.decision_boundary(q, torch.tensor([2]), 3), (p,),
        (torch.tensor([[1.0, 3.0, 0.0]]),))
    assert float(vdot) == pytest.approx(2.0, abs=1e-6)


@pytest.mark.parametrize("step,length", [(0, 0), (7, 20), (40, 20)])
def test_kappa_schedules_match_jax(step, length):
    assert tly.anneal_kappa(step, 2.0, length) == float(
        jly.anneal_kappa(jnp.asarray(step), 2.0, length))
    Lfx = 3.5
    jk = jly.lips_kappa(jnp.asarray(step), 0.5, length, 36 / 255,
                        jnp.asarray(Lfx), 3)
    tk = tly.lips_kappa(step, 0.5, length, 36 / 255, torch.tensor(Lfx), 3)
    np.testing.assert_allclose(float(tk), float(jk), rtol=1e-7)


@pytest.mark.parametrize("act,relax,barrier", [
    ("relu", False, False), ("elu", True, True), ("identity", False, True)])
@pytest.mark.parametrize("name", ["DecisionBoundary", "DynCrossEntropy"])
def test_lyapunov_loss_matches_jax(name, act, relax, barrier):
    h, f, y = _states(1)
    f_tilde = f + 0.5
    kw = dict(current_kappa=2.0, alpha_1=100.0, alpha_2=20.0, act=act,
              relax_exp_stable=relax, scale_l_eps=3.0, eps=0.141,
              barrier_loss=barrier)

    def jax_loss(fj):
        return jly.lyapunov_loss(
            h=jnp.asarray(h), f=fj, f_tilde=jnp.asarray(f_tilde),
            y=jnp.asarray(y), lya_cand=jly.get_lya_candidate(name, N),
            output_fn=lambda p: p, **kw)

    (jl, jm), jg = jax.value_and_grad(jax_loss, has_aux=True)(jnp.asarray(f))
    ft = _t(f).requires_grad_()
    tl, tm = tly.lyapunov_loss(
        h=_t(h), f=ft, f_tilde=_t(f_tilde), y=_t(y).long(),
        lya_cand=tly.get_lya_candidate(name, N), output_fn=lambda p: p, **kw)
    tl.backward()
    assert abs(float(tl) - float(jl)) <= 1e-6
    for key in tly.METRICS:
        np.testing.assert_allclose(float(tm[key]), float(getattr(jm, key)),
                                   rtol=0, atol=1e-6, err_msg=key)
    np.testing.assert_allclose(ft.grad.numpy(), np.asarray(jg), rtol=0,
                               atol=1e-6)


def _jax_draws(name, key, B, S, lim):
    """The base draws of JAX's sampler ``name`` at ``key``."""
    if name in ("UniformSimplexSampling", "CorrectConeSampling"):
        return (jax.random.exponential(key, (B, S, N)),)
    if name == "BandSimplexSampling":
        k1, k2 = jax.random.split(key)
        return (jax.random.exponential(k1, (B, S, N)),
                jax.random.uniform(k2, (B, S), minval=0.1, maxval=1.0))
    if name == "ProjectedBiasedHyperSphereSampling":
        k1, k2 = jax.random.split(key)
        return (jax.random.uniform(k1, (B, S, 1), maxval=jnp.sqrt(N * lim ** 2)),
                jax.random.normal(k2, (B, S, N)))
    if name == "ProjectedHyperCubeSampling":
        return (jax.random.uniform(key, (B, S, N), minval=-lim, maxval=lim),)
    return (jax.random.exponential(key, (B, S, N - 1)),)


STATELESS = [n for n in jsamp.SAMPLERS if n != "TrajectorySampler"]


@pytest.mark.parametrize("name", STATELESS)
def test_sampler_matches_jax_on_its_draws(name):
    B, S, lim = 4, 8, 15.0
    y = np.asarray([0, 3, 9, 5], np.int32)
    key = jax.random.PRNGKey(11)
    want = np.asarray(jsamp.SAMPLERS[name](key, jnp.asarray(y), N, S,
                                           h_dist_lim=lim))
    draws = [_t(d) for d in _jax_draws(name, key, B, S, lim)]
    got = tsamp.SAMPLERS[name](_t(y).long(), N, S, *draws).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    # the port's own draws have the JAX draws' shapes
    own = tsamp.draw(name, B, N, S, h_dist_lim=lim,
                     generator=torch.Generator().manual_seed(0))
    assert [tuple(d.shape) for d in own] == [tuple(d.shape) for d in draws]


@pytest.mark.parametrize("mixer", [[1.0, 0.0], [0.0, 1.0], [0.3, 0.7],
                                   [0.02, 0.98], [1 / 3, 1 / 3, 1 / 3]])
def test_composite_sample_slot_owners_match_jax(mixer):
    """With every sampler's draws replaced by its index, the mixture shows
    which sampler owns each slot."""
    names = ["UniformSimplexSampling", "CorrectConeSampling",
             "DecisionBoundarySampling"][:len(mixer)]
    S = 13
    y = np.asarray([1, 2], np.int32)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jsamp.composite_sample(
        key, names, jnp.asarray(mixer, jnp.float32), jnp.asarray(y), N, S))
    keys = jax.random.split(key, len(names))
    draws = [[_t(d) for d in _jax_draws(n, k, 2, S, 15.0)]
             for n, k in zip(names, keys)]
    got = tsamp.composite_sample(names, np.asarray(mixer, np.float32),
                                 _t(y).long(), N, S, draws=draws).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    counts = tsamp.slot_counts(np.asarray(mixer, np.float32), S)
    owners = np.repeat(np.arange(len(names)), counts)
    edges = np.cumsum(np.floor(S * np.asarray(mixer, np.float32)).astype(int))
    edges[-1] = S
    assert (owners == np.sum(np.arange(S)[:, None] >= edges[None, :], -1)).all()


def test_trajectory_sampler_matches_jax_solve():
    """TrajectorySampler: the hidden states of the solved trajectory, within
    the solve-endpoint tolerance 1e-3."""
    from fiode_tpu.models.dynamics import SimplexDynamics as JaxDynamics
    from fiode_tpu.models.ivp import NeuralODEClassifier as JaxClassifier
    from fiode_tpu_torch.models.dynamics import SimplexDynamics
    from fiode_tpu_torch.models.ivp import NeuralODEClassifier

    jm = JaxClassifier(backbone=None, dynamics=JaxDynamics(
        n_hidden=N, mlp_size=16, x_dim=6, dropout=0.0), n_classes=N,
        max_steps=16)
    x = np.random.default_rng(0).uniform(size=(3, 6)).astype(np.float32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(jax.jit(lambda p, xa: jsamp.trajectory_sampler(
        None, jnp.zeros(3, jnp.int32), N, 5, model=jm, params=p, x=xa))(
            params, jnp.asarray(x)))
    tm = NeuralODEClassifier(None, SimplexDynamics(
        n_hidden=N, mlp_size=16, x_dim=6, dropout=0.0), max_steps=16)
    params_from_numpy(tm, jax.tree_util.tree_map(np.asarray, params))
    got = tsamp.SAMPLERS["TrajectorySampler"](
        torch.zeros(3, dtype=torch.long), N, 5, model=tm, x=_t(x)).numpy()
    assert got.shape == want.shape == (3, 5, N)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_augment_batch_matches_jax_on_its_draws():
    x = np.random.default_rng(0).uniform(size=(16, 3, 8, 8)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    want = np.asarray(jax_augment(key, jnp.asarray(x)))
    kc, kf = jax.random.split(key)
    off = _t(jax.random.randint(kc, (16, 2), 0, 9))
    flip = _t(jax.random.bernoulli(kf, 0.5, (16,)))
    got = augment_batch(_t(x), draws=(off, flip)).numpy()
    np.testing.assert_array_equal(got, want)
    assert flip.any() and not flip.all()


@pytest.mark.parametrize("kind", ["linear_min", "linear_max", "constant",
                                  "switch"])
def test_schedulers_match_jax_over_300_epochs(kind):
    def make(mod):
        return {
            "linear_min": lambda: mod.LinearScheduler(rate=-0.02, bias=1.0, clamp="min", clamp_val=0.02, start=10),
            "linear_max": lambda: mod.LinearScheduler(rate=0.02, clamp="max", clamp_val=0.98, start=10),
            "constant": lambda: mod.ConstantScheduler(0.7),
            "switch": lambda: mod.SwitchScheduler(0.2, 0.9, 50),
        }[kind]()

    def composite(mod):
        return mod.CompositeSamplerScheduler(
            [make(mod), mod.LinearScheduler(rate=0.02, clamp="max", clamp_val=0.98, start=10)],
            [1.0, 2.0])

    jc, tc = composite(jsch), composite(tsch)
    for epoch in range(301):
        assert make(tsch).sampler_weight(epoch) == make(jsch).sampler_weight(epoch)
        np.testing.assert_array_equal(tc.get_mixer_coefficients(epoch),
                                      jc.get_mixer_coefficients(epoch))


def test_compute_lfx_matches_jax():
    mu, std = (0.5,) * 3, (0.25,) * 3
    jb = JaxPlainCNN(arch="4C3F", out_dim=10, act="ReLU", mu=mu, std=std)
    x = jnp.zeros((1, 3, 16, 16))
    params = jax.jit(jb.init)(jax.random.PRNGKey(1), x)["params"]
    us = jax_lfx_init(jb, params, (3, 16, 16), jax.random.PRNGKey(2))
    jl, jus = jax.jit(lambda p, u: jax_compute_lfx(jb, p, u, (3, 16, 16),
                                                   n_iter=3))(params, us)

    tb = PlainCNNBackbone("4C3F", out_dim=10, act="ReLU", mu=mu, std=std,
                          img_size=16)
    params_from_numpy(tb, jax.tree_util.tree_map(np.asarray, params))
    own = lfx_init(tb, (3, 16, 16), torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in own.items()} == {
        k: tuple(v.shape) for k, v in us.items()}
    tl, tus = compute_lfx(tb, {k: _t(v) for k, v in us.items()}, (3, 16, 16),
                          n_iter=3)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for k in jus:
        np.testing.assert_allclose(tus[k].numpy(), np.asarray(jus[k]),
                                   rtol=0, atol=1e-5, err_msg=k)


CONFIGS = sorted(glob.glob(str(REPO / "configs" / "**" / "*.yaml"),
                           recursive=True))


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: Path(p).name)
def test_yaml_reader_matches_pyyaml(path):
    text = Path(path).read_text()
    assert tcfg.load_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: Path(p).name)
def test_compose_matches_jax(path):
    p = Path(path)
    overrides = ["++batch_size=64", "module.lr=1e-4", "++synthetic_size=512",
                 "+module/init_fun/param_map@module.init_fun.param_map=TinyMLP",
                 "++module.sampler_scheduler.scheduler_weights=[1.0, 0.5]",
                 "++module.dynamics.cayley=false", "++note='a b'"]
    for ov in ([], overrides):
        assert tcfg.compose(p.name, ov, config_dir=str(p.parent)) == \
            jcfg.compose(p.name, ov, config_dir=str(p.parent))


@pytest.mark.parametrize("text", [
    "1.0e-3", "1e-3", "5", "-0.02", "010", "0x1F", ".5", "true", "Off", "~",
    "null", "min", "'quoted # text'", '"2"', "[1, 2.5, a]",
    "{a: 1, b: [x, y], '': c}", "{}", "[]", "1.0e3", "+7", "a b"])
def test_yaml_scalars_match_pyyaml(text):
    assert tcfg.parse_value(text) == yaml.safe_load(text)
