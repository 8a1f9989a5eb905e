"""Branch-and-bound refinement of the Lipschitz certificate: the port
(``fiode_tpu_torch.verify.refine_lips``) against the JAX package
(``fiode_tpu.verify.refine_lips``) on the CPU.

A tiny model (TinyMLP backbone, n = 3, mlp 16) with the JAX parameters
bridged into the port, T = 8, eps_input 0.01, six seeded images: none passes
the with-slack certificate, two carry an exact lattice violation, and within
12 rounds refinement closes three of the rest.  ``refine_lips_uncertified``
gives the same statistics in both packages, for ReLU dynamics (the centre
field through ``fused_rhs``, kernel K1 on CUDA) and for GroupSort dynamics
(through ``eval_dot``); one box step's values agree within STEP_TOL; the
mechanics of the JAX tests (tests/test_verify.py) are held on the port.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fiode_tpu.models.backbones import TinyMLPBackbone as JaxTinyMLP
from fiode_tpu.models.dynamics import SimplexDynamics as JaxDynamics
from fiode_tpu.models.ivp import NeuralODEClassifier as JaxClassifier
from fiode_tpu.verify import refine_lips as jrefine_lips
from fiode_tpu.verify.certify import Certifier as JaxCertifier
from fiode_tpu_torch import params_from_numpy
from fiode_tpu_torch.models.backbones import TinyMLPBackbone
from fiode_tpu_torch.models.dynamics import SimplexDynamics
from fiode_tpu_torch.models.ivp import NeuralODEClassifier
from fiode_tpu_torch.verify import certify as tcertify
from fiode_tpu_torch.verify import refine as trefine
from fiode_tpu_torch.verify import refine_lips as trefine_lips
from fiode_tpu_torch.verify import refine_lips_uncertified
from fiode_tpu_torch.verify.certify import Certifier, label_perms

N, X_DIM, MLP, HIDDEN, T = 3, 6, 16, 16, 8
N_IMAGES, MAX_STEPS, EPS_INPUT = 6, 32, 0.01
STEP_TOL = 1e-5
BUDGETS = dict(chunk=512, superchunk=1, max_rounds=12, frontier_cap=1 << 14,
               box_budget=200_000)


def _pair(activation):
    kw = dict(n_hidden=N, mlp_size=MLP, x_dim=X_DIM, dropout=0.0,
              activation=activation, alpha_1=100.0, alpha_2=20.0,
              sigma_1=0.02)
    jmodel = JaxClassifier(
        backbone=JaxTinyMLP(out_dim=X_DIM, hidden=HIDDEN, mu=(0.5,),
                            std=(0.25,)),
        dynamics=JaxDynamics(cayley=True, **kw), n_classes=N,
        max_steps=MAX_STEPS)
    x = np.random.default_rng(0).uniform(
        size=(N_IMAGES, 1, 8, 8)).astype(np.float32)
    params = jmodel.init(jax.random.PRNGKey(1), jnp.asarray(x))
    tmodel = NeuralODEClassifier(
        TinyMLPBackbone(64, out_dim=X_DIM, hidden=HIDDEN, mu=(0.5,),
                        std=(0.25,)),
        SimplexDynamics(**kw), max_steps=MAX_STEPS).eval()
    params_from_numpy(tmodel, jax.tree_util.tree_map(np.asarray, params))
    with torch.no_grad():  # the predicted classes (both packages agree)
        y = tmodel.predict(torch.from_numpy(x)).argmax(-1).numpy()
    ckw = dict(T=T, eps_input=EPS_INPUT, chunk=BUDGETS["chunk"])
    jcert = JaxCertifier(jmodel, params, **ckw)
    tcert = Certifier(tmodel, **ckw)
    res = tcert.certify(x, y, method="lipschitz", early_exit=False)
    return types.SimpleNamespace(jmodel=jmodel, params=params, tmodel=tmodel,
                                 x=x, y=y, jcert=jcert, tcert=tcert, res=res)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    # thousands of tiny CPU ops per run: one intra-op thread is faster, and
    # does not oversubscribe the cores that parallel test workers share
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def relu():
    s = _pair("ReLU")
    assert s.res.clean.all() and not s.res.certified.any()
    s.refined = refine_lips_uncertified(
        s.tcert, s.x, s.y, s.res.certified, exact_ok=s.res.larger_T_certified,
        clean=s.res.clean, **BUDGETS)
    return s


def _fields(s):
    return (s.image, s.base_violated, s.rounds, s.boxes_evaluated,
            s.certified, s.gave_up, s.pre_alpha_violated)


def _jax_refine(s):
    return jrefine_lips.refine_lips_uncertified(
        s.jcert, s.x, s.y, s.res.certified, exact_ok=s.res.larger_T_certified,
        clean=s.res.clean, **BUDGETS)


def test_refine_lips_matches_jax(relu):
    got_cert, got = relu.refined
    want_cert, want = _jax_refine(relu)
    assert [_fields(s) for s in got] == [_fields(s) for s in want]
    np.testing.assert_array_equal(got_cert, want_cert)
    # every outcome: certified, an exact violation, out of rounds
    assert {s.gave_up for s in got} == {"", "exact_violation", "rounds"}
    assert 0 < got_cert.sum()


def test_refine_lips_groupsort_dynamics_match_jax():
    # the centre field of GroupSort dynamics is their eval_dot in both
    # packages, not K1's ReLU field
    s = _pair("GroupSort")
    before = tcertify.fused_rhs.launches
    got_cert, got = refine_lips_uncertified(
        s.tcert, s.x, s.y, s.res.certified, exact_ok=s.res.larger_T_certified,
        clean=s.res.clean, **BUDGETS)
    assert tcertify.fused_rhs.launches == before
    want_cert, want = _jax_refine(s)
    assert [_fields(a) for a in got] == [_fields(b) for b in want]
    np.testing.assert_array_equal(got_cert, want_cert)
    assert any(a.boxes_evaluated for a in got)


def test_refine_lips_sound_and_only_adds(relu):
    new_cert, stats = relu.refined
    res = relu.res
    assert (~res.certified | new_cert).all()
    assert (~new_cert | res.larger_T_certified).all()
    assert len(stats) == int((res.clean & ~res.certified).sum())
    for s in stats:
        assert s.certified == bool(new_cert[s.image])
        if not res.larger_T_certified[s.image]:
            assert s.gave_up == "exact_violation" and not s.certified
            assert s.boxes_evaluated == 0 and s.base_violated == -1


def test_refine_lips_computes_exact_ok_when_not_given(relu):
    got_cert, got = refine_lips_uncertified(
        relu.tcert, relu.x, relu.y, relu.res.certified, **BUDGETS)
    want_cert, want = relu.refined
    np.testing.assert_array_equal(got_cert, want_cert)
    assert [_fields(s) for s in got] == [_fields(s) for s in want]


def test_refine_lips_partitioned_past_device_cap_keeps_verdicts(relu):
    cap_cert, capped = refine_lips_uncertified(
        relu.tcert, relu.x, relu.y, relu.res.certified,
        exact_ok=relu.res.larger_T_certified, clean=relu.res.clean,
        device_cap=32, **BUDGETS)
    base_cert, base = relu.refined
    np.testing.assert_array_equal(cap_cert, base_cert)
    assert [(s.image, s.gave_up) for s in capped] == \
        [(s.image, s.gave_up) for s in base]


def test_refine_lips_collect_cap_and_resume(relu):
    streamed = []
    _, stats = refine_lips_uncertified(
        relu.tcert, relu.x, relu.y, relu.res.certified,
        exact_ok=relu.res.larger_T_certified, collect_cap=2,
        on_image=streamed.append, **BUDGETS)
    assert streamed == stats
    for s in stats:
        assert s.gave_up in ("collect_cap", "exact_violation")
        assert not s.certified
    skip = np.ones(N_IMAGES, bool)
    skip[2:4] = False
    _, part = refine_lips_uncertified(
        relu.tcert, relu.x, relu.y, relu.res.certified,
        exact_ok=relu.res.larger_T_certified, skip=skip, **BUDGETS)
    assert [s.image for s in part] == [2, 3]


def _box_inputs(cert, x, y, k):
    image = trefine._images(cert, torch.from_numpy(x), [k])
    return image(0, y[k])


def test_lips_box_evaluator_consistent_with_sweep(relu):
    # at a base cell (on-lattice centre, uniform 1/T half-widths) the box
    # bound dominates the sweep value; a box far off the simplex plane is
    # vacuous; split dims are coordinates
    sweep_fn, step_fn = trefine_lips._lips_kernels(relu.tcert)
    img = _box_inputs(relu.tcert, relu.x, relu.y, 0)
    perm = label_perms(torch.tensor([img.label]), N)[0]
    g = torch.from_numpy(relu.tcert.grid)[:, perm]
    e = torch.full_like(g, relu.tcert.eps)
    with torch.no_grad():
        sweep = sweep_fn(g, img)
        box, dims = step_fn(g, e, img)
        far, _ = step_fn(g + 1.0, torch.full_like(g, 1e-4), img)
    assert (box >= sweep - 1e-5).all()
    assert (far == -np.inf).all()
    assert ((dims >= 0) & (dims < N)).all()
    # the sweep value is the Certifier's with-slack worst over the grid
    assert float(sweep.max()) == pytest.approx(float(relu.res.worst[0]),
                                               abs=1e-6)


@pytest.mark.parametrize("k", [0, 4])
def test_lips_step_values_match_jax(relu, k):
    _, box_step_fn, _, _ = jrefine_lips._lips_kernels(relu.jcert)
    rng = np.random.default_rng(k)
    C = 64
    c = rng.dirichlet(np.ones(N), C).astype(np.float32)
    e = rng.uniform(0.002, 0.05, (C, N)).astype(np.float32)
    feats = np.asarray(relu.jcert._features(relu.jcert.params,
                                            jnp.asarray(relu.x)))[k]
    want_v, want_d = box_step_fn(jnp.asarray(c[None]), jnp.asarray(e[None]),
                                 jnp.asarray(feats), int(relu.y[k]))
    _, step_fn = trefine_lips._lips_kernels(relu.tcert)
    with torch.no_grad():
        v, d = step_fn(torch.from_numpy(c), torch.from_numpy(e),
                       _box_inputs(relu.tcert, relu.x, relu.y, k))
    np.testing.assert_allclose(v.numpy(), np.asarray(want_v)[0],
                               atol=STEP_TOL)
    assert (d.numpy() == np.asarray(want_d)[0]).mean() >= 0.9


def test_refine_lips_centre_field_goes_through_fused_rhs(relu, monkeypatch):
    calls = []
    real = tcertify.fused_rhs

    def spy(*args, **kw):
        calls.append(args[0].shape[0])
        return real(*args, **kw)

    monkeypatch.setattr(tcertify, "fused_rhs", spy)
    _, stats = refine_lips_uncertified(
        relu.tcert, relu.x[:1], relu.y[:1], relu.res.certified[:1],
        exact_ok=relu.res.larger_T_certified[:1], **BUDGETS)
    assert stats[0].boxes_evaluated > 0
    # the sweep's padded block, then every BaB round's boxes
    assert sum(calls) == BUDGETS["chunk"] + stats[0].boxes_evaluated
