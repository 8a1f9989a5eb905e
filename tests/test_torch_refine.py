"""Branch-and-bound refinement of the CROWN certificate: the port
(``fiode_tpu_torch.verify.refine``) against the JAX package
(``fiode_tpu.verify.refine``) on the CPU.

A tiny model (TinyMLP backbone, n = 5, mlp 16) with the JAX parameters
bridged into the port, T = 10 (65 grid cells), eps_input 0.005, six seeded
images, none certified by the one-shot CROWN sweep.  The whole
``refine_uncertified`` (plain and hybrid ``lips_box``) and
``hybrid_base_sweep`` give the same statistics in both packages (verdict,
violated cells, rounds, boxes, give-up) below the JAX package's
device-resident threshold; one box step's values agree within STEP_TOL and
its split dimensions wherever JAX's two best scores are apart; the split
arithmetic is bit-equal.  The mechanics of the JAX tests
(tests/test_verify.py) are held on the port: analytic bounds, NaN fails
closed, soundness and only-adds, the hybrid bound's soundness fuzz, the
resume hooks, ``order``, ``image_seconds``, the alpha evaluator and the
partitioning past ``device_cap``.
"""
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fiode_tpu import experiment as jexperiment
from fiode_tpu.models.backbones import TinyMLPBackbone as JaxTinyMLP
from fiode_tpu.models.dynamics import SimplexDynamics as JaxDynamics
from fiode_tpu.models.ivp import NeuralODEClassifier as JaxClassifier
from fiode_tpu.verify import refine as jrefine
from fiode_tpu.verify.certify import Certifier as JaxCertifier
from fiode_tpu.verify.crown import crown_mlp_bounds as jax_crown
from fiode_tpu.verify.ibp_qp import ibp_cbf_qp as jax_qp
from fiode_tpu.verify.ibp_qp import worst_case_vdot as jax_vdot
from fiode_tpu_torch import params_from_numpy
from fiode_tpu_torch.experiment import run_certify
from fiode_tpu_torch.models.backbones import TinyMLPBackbone
from fiode_tpu_torch.models.dynamics import SimplexDynamics
from fiode_tpu_torch.models.ivp import NeuralODEClassifier
from fiode_tpu_torch.ops.fused_rhs import fused_rhs
from fiode_tpu_torch.verify import (RefineStats, SweepStats, hybrid_base_sweep,
                                    refine_uncertified)
from fiode_tpu_torch.verify import refine as trefine
from fiode_tpu_torch.verify.certify import Certifier

N, X_DIM, MLP, HIDDEN, T = 5, 6, 16, 16, 10
N_IMAGES, MAX_STEPS, EPS_INPUT = 6, 32, 0.005
# one box step: float32 round-off of two frameworks' CROWN products and
# 30-step bisections on the same boxes
STEP_TOL = 1e-5
# the split dims must agree where JAX's best score beats its runner-up by
# more than this, relatively
SCORE_GAP = 1e-6
BUDGETS = dict(chunk=512, superchunk=1, max_rounds=6, frontier_cap=4096,
               box_budget=20000)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    # thousands of tiny CPU ops per run: one intra-op thread is faster, and
    # does not oversubscribe the cores that parallel test workers share
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    kw = dict(n_hidden=N, mlp_size=MLP, x_dim=X_DIM, dropout=0.0,
              alpha_1=100.0, alpha_2=20.0, sigma_1=0.02)
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
    res_c = tcert.certify(x, y, method="crown", early_exit=False)
    res_l = tcert.certify(x, y, method="lipschitz", early_exit=False)
    assert res_c.clean.all() and not res_c.certified.any()
    return types.SimpleNamespace(jmodel=jmodel, params=params, tmodel=tmodel,
                                 x=x, y=y, jcert=jcert, tcert=tcert,
                                 res_c=res_c, res_l=res_l)


@pytest.fixture(scope="module")
def runs(setup):
    """The port's refine_uncertified by keyword set, run once each; with
    ``streamed=True`` also what ``on_image`` received."""
    cache = {}

    def get(streamed=False, **kw):
        key = tuple(sorted(kw.items()))
        if key not in cache:
            stream = []
            cache[key] = refine_uncertified(
                setup.tcert, setup.x, setup.y, setup.res_c.certified,
                clean=setup.res_c.clean, on_image=stream.append,
                **dict(BUDGETS, **kw)) + (stream,)
        return cache[key] if streamed else cache[key][:2]

    return get


def _fields(s):
    return (s.image, s.base_violated, s.rounds, s.boxes_evaluated,
            s.certified, s.gave_up, s.pre_alpha_violated)


@pytest.mark.parametrize("lips_box", [False, True])
def test_refine_uncertified_matches_jax(setup, runs, lips_box):
    got_cert, got = runs(lips_box=lips_box)
    want_cert, want = jrefine.refine_uncertified(
        setup.jcert, setup.x, setup.y, setup.res_c.certified,
        clean=setup.res_c.clean, lips_box=lips_box, **BUDGETS)
    assert [_fields(s) for s in got] == [_fields(s) for s in want]
    np.testing.assert_array_equal(got_cert, want_cert)
    # the case exercises both outcomes, below JAX's device-resident path
    assert 0 < got_cert.sum() < N_IMAGES
    assert max(s.boxes_evaluated for s in got) < (1 << 21)
    # records of either package parse as the other's
    for s in want:
        assert _fields(RefineStats(**vars(s))) == _fields(got[s.image])


def test_refine_sound_and_only_adds(setup, runs):
    new_cert, stats = runs()
    assert (~setup.res_c.certified | new_cert).all()
    assert (~new_cert | setup.res_l.larger_T_certified).all(), (
        "refinement certified an image with exact grid violations")
    assert len(stats) == int((setup.res_c.clean
                              & ~setup.res_c.certified).sum())
    for s in stats:
        assert s.certified == bool(new_cert[s.image])
        assert s.pre_alpha_violated == s.base_violated


def test_refine_lips_box_never_looser(setup, runs):
    plain_cert, _ = runs()
    hyb_cert, hyb = runs(lips_box=True)
    assert (~plain_cert | hyb_cert).all()
    assert (~hyb_cert | setup.res_l.larger_T_certified).all()


def _jax_step(setup, k, c, e):
    """JAX's box step on (C, n) boxes of image k: values, split dims, and
    the scores the dims are the argmax of (JAX's val and vjp, rebuilt from
    its public functions as refine._kernels composes them)."""
    jcert = setup.jcert
    _, box_step_fn, _, _ = jrefine._kernels(jcert)
    feats = np.asarray(jcert._features(jcert.params, jnp.asarray(setup.x)))
    xb = jnp.asarray(feats[k] @ np.asarray(jcert.U).T + np.asarray(jcert.bU))
    label = int(setup.y[k])
    vals, dims = box_step_fn(jnp.asarray(c[None]), jnp.asarray(e[None]), xb,
                             label)
    Ws = [jnp.asarray(W) for W in jcert.Ws]
    bs = [jnp.asarray(b) for b in jcert.bs]
    a1, s1, a2 = jcert.alpha_1, jcert.sigma_1, jcert.alpha_2

    def val(ee):
        with jax.default_matmul_precision("float32"):
            x_rows = jnp.broadcast_to(xb, (c.shape[0], xb.shape[-1]))
            lb, ub = jax_crown(Ws, bs, jnp.asarray(c), ee, x_rows)
            f_lb, f_ub = jax_qp(jnp.asarray(c), ee, lb, ub, a1, s1, a2)
            return jax_vdot(jnp.asarray(c), ee, f_lb, f_ub, label) \
                + jcert.kappa

    v, vjp = jax.vjp(val, jnp.asarray(e))
    (g,) = vjp(jnp.ones_like(v))
    score = e * (np.abs(np.nan_to_num(np.asarray(g))) + 1e-30)
    return np.asarray(vals)[0], np.asarray(dims)[0], score


@pytest.mark.parametrize("k", [0, 3])
def test_step_values_and_split_dims_match_jax(setup, k):
    rng = np.random.default_rng(k)
    C = 96
    c = rng.dirichlet(np.ones(N), C).astype(np.float32)
    e = rng.uniform(0.005, 0.06, (C, N)).astype(np.float32)
    want_v, want_d, score = _jax_step(setup, k, c, e)
    _, step_fn = trefine._kernels(setup.tcert)
    image = trefine._images(setup.tcert, torch.from_numpy(setup.x), [k])
    with torch.no_grad():
        v, d = step_fn(torch.from_numpy(c), torch.from_numpy(e),
                       image(0, setup.y[k]))
    np.testing.assert_allclose(v.numpy(), want_v, atol=STEP_TOL)
    top2 = np.sort(score, -1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > SCORE_GAP * top2[:, 1]
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(d.numpy()[clear], want_d[clear])


def test_split_children_bit_equal_to_jax():
    rng = np.random.default_rng(7)
    R, n = 4096, 6
    oc = (rng.uniform(-1.0, 1.0, (R, n)) * 10 ** rng.uniform(
        -3, 0, (R, 1))).astype(np.float32)
    oe = (10.0 ** rng.uniform(-7, -1, (R, n))).astype(np.float32)
    # centres and half-widths at powers of two, where the spacing steps
    oc[:512] = (2.0 ** rng.integers(-12, 1, (512, n))
                * rng.choice([-1, 1], (512, n))).astype(np.float32)
    oe[:256] = (2.0 ** rng.integers(-20, -2, (256, n))).astype(np.float32)
    d = rng.integers(0, n, R)
    want = jrefine._split_children(oc, oe, d)
    got = trefine._split_children(torch.from_numpy(oc), torch.from_numpy(oe),
                                  torch.from_numpy(d))
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy().view(np.int32),
                                      b.view(np.int32))


def test_split_children_cover_parent_in_fp32():
    rng = np.random.default_rng(8)
    R, n = 4096, 6
    oc = torch.from_numpy((rng.uniform(-1.0, 1.0, (R, n)) * 10 ** rng.uniform(
        -3, 0, (R, 1))).astype(np.float32))
    oe = torch.from_numpy((10.0 ** rng.uniform(-7, -1, (R, n))).astype(
        np.float32))
    d = torch.from_numpy(rng.integers(0, n, R))
    lo, hi, ce_lo, ce_hi = trefine._split_children(oc, oe, d)
    rows = torch.arange(R)
    c, e = oc[rows, d], oe[rows, d]
    assert (lo[rows, d] - ce_lo[rows, d] <= c - e).all()
    assert (hi[rows, d] + ce_hi[rows, d] >= c + e).all()
    assert (lo[rows, d] + ce_lo[rows, d] >= hi[rows, d] - ce_hi[rows, d]).all()
    keep = torch.ones(R, n, dtype=torch.bool)
    keep[rows, d] = False
    assert torch.equal(lo[keep], oc[keep]) and torch.equal(ce_hi[keep], oe[keep])


def _analytic(offset):
    """val = sum(eps) + offset, widest-dim splits (a constant gradient)."""
    def port(c, e, img):
        return e.sum(-1) + offset, e.argmax(-1)

    def jax_(c, e, xb, lab):
        return jnp.sum(e, -1) + offset, jnp.argmax(e, -1).astype(jnp.int32)

    return port, jax_


@pytest.mark.parametrize("offset,closes", [(-0.3, True), (-0.45, True),
                                           (0.1, False)])
def test_bab_mechanics_on_analytic_bound(offset, closes):
    # sum(eps) - 0.3 closes after a few halvings; sum(eps) + 0.1 never does
    # and must trip a budget, not loop.  The port's rounds and boxes are
    # JAX's host path's.
    port, jax_ = _analytic(offset)
    centers = np.zeros((3, 4), np.float32)
    kw = dict(max_rounds=12, frontier_cap=1 << 12, box_budget=1 << 16)
    got = trefine._bab(port, None, torch.from_numpy(centers), 0.2, block=8,
                       **kw)
    want = jrefine._bab(jax_, None, 0, centers, 0.2, 4, chunk=8, **kw)
    assert got == want
    assert got[0] == closes and (got[3] == "") == closes


def test_bab_checks_its_budgets_in_jax_order():
    port, jax_ = _analytic(0.1)
    centers = np.zeros((3, 4), np.float32)
    for kw in (dict(max_rounds=0, frontier_cap=0, box_budget=0),
               dict(max_rounds=20, frontier_cap=16, box_budget=0),
               dict(max_rounds=20, frontier_cap=1 << 10, box_budget=40)):
        got = trefine._bab(port, None, torch.from_numpy(centers), 0.2,
                           block=8, **kw)
        assert got == jrefine._bab(jax_, None, 0, centers, 0.2, 4, chunk=8,
                                   **kw)
    assert [trefine._bab(port, None, torch.from_numpy(centers), 0.2, block=8,
                         max_rounds=20, frontier_cap=1 << 10,
                         box_budget=1 << 20, deadline=0.0)[3]] == ["time_budget"]


def test_bab_nan_fails_closed():
    def nan_step(c, e, img):
        return torch.full(e.shape[:-1], float("nan")), e.argmax(-1)

    ok, rounds, boxes, gave = trefine._bab(
        nan_step, None, torch.zeros(2, 4), 0.2, block=8, max_rounds=4,
        frontier_cap=1 << 10, box_budget=1 << 14)
    assert not ok and gave != ""


def test_bab_partitions_past_device_cap():
    # a frontier that outgrows the device cap is partitioned into
    # sub-frontiers that each run to closure: the verdict stands, every box
    # is bounded once as in one frontier, over more (smaller) rounds
    port, _ = _analytic(-0.45)
    centers = torch.zeros(3, 4)
    kw = dict(block=8, max_rounds=40, frontier_cap=1 << 16,
              box_budget=1 << 22)
    whole = trefine._bab(port, None, centers, 0.2, **kw)
    seen = []

    def spy(c, e, img):
        seen.append(len(c))
        return port(c, e, img)

    parts = trefine._bab(spy, None, centers, 0.2, device_cap=16, **kw)
    assert whole[0] and parts[0] and parts[3] == ""
    assert parts[2] == whole[2] and parts[1] > whole[1]
    assert max(seen) <= 16
    # a hopeless bound still trips a budget under partitioning
    hopeless, _ = _analytic(0.1)
    ok, _, _, gave = trefine._bab(hopeless, None, centers, 0.2, device_cap=16,
                                  block=8, max_rounds=10, frontier_cap=1 << 10,
                                  box_budget=1 << 14)
    assert not ok and gave in ("rounds", "frontier_cap", "budget")


def test_refine_partitioned_past_device_cap_keeps_verdicts(setup, runs):
    base_cert, base = runs()
    cap_cert, capped = runs(device_cap=64)
    np.testing.assert_array_equal(cap_cert, base_cert)
    for a, b in zip(base, capped):
        assert (a.image, a.base_violated, a.certified) == \
            (b.image, b.base_violated, b.certified)
        if a.certified:
            assert b.boxes_evaluated == a.boxes_evaluated


def test_lips_box_bound_sound_fuzz(setup):
    """The hybrid min(CROWN, exact centre + local Lipschitz) box bound
    upper-bounds the exact Vdot at sampled points of every box, including
    points whose argmax-wrong class differs from the centre's."""
    tcert, tmodel = setup.tcert, setup.tmodel
    _, step_fn = trefine._kernels(tcert, lips_box=True)
    x = torch.from_numpy(setup.x)
    image = trefine._images(tcert, x, [0, 3])
    rng = np.random.default_rng(0)
    for k, i in enumerate((0, 3)):
        label = int(setup.y[i])
        C = 16
        centers = rng.dirichlet(np.ones(N), C).astype(np.float32)
        epss = rng.uniform(0.01, 0.15, (C, N)).astype(np.float32)
        with torch.no_grad():
            vals, _ = step_fn(torch.from_numpy(centers),
                              torch.from_numpy(epss), image(k, label))
            u = rng.uniform(-1.0, 1.0, (C, 8, N)).astype(np.float32)
            pts = torch.from_numpy(
                (centers[:, None] + u * epss[:, None]).reshape(-1, N))
            feats = tmodel.features(x[i:i + 1]).expand(len(pts), -1)
            f = tmodel.dynamics.eval_dot(pts, feats).numpy()
        onehot = np.arange(N) == label
        wrong = np.where(onehot, -np.inf, pts.numpy())
        tie = wrong == wrong.max(-1, keepdims=True)
        vdot = (-np.where(onehot, f, 0.0).sum(-1)
                + np.where(tie, f, -np.inf).max(-1) + tcert.kappa)
        assert (vdot.reshape(C, 8).max(-1) <= vals.numpy() + 1e-4).all()


def test_lips_box_runs_k1_through_the_certifiers_field(setup, monkeypatch):
    # the exact centre value goes through Certifier.exact_field, which is
    # fused_rhs (K1 on CUDA) for ReLU dynamics
    from fiode_tpu_torch.verify import certify as tcertify
    calls = []

    def spy(*args, **kw):
        calls.append(args[0].shape[0])
        return fused_rhs(*args, **kw)

    monkeypatch.setattr(tcertify, "fused_rhs", spy)
    stats = hybrid_base_sweep(setup.tcert, setup.x[:1], setup.y[:1],
                              chunk=32, superchunk=1)
    assert len(stats) == 1 and sum(calls) == 65  # the grid's 65 cells


def test_hybrid_base_sweep_matches_jax_and_dominates(setup):
    x, y = setup.x, setup.y
    got = hybrid_base_sweep(setup.tcert, x, y, chunk=32, superchunk=2)
    want = jrefine.hybrid_base_sweep(setup.jcert, x, y, chunk=32,
                                     superchunk=2)
    plain = hybrid_base_sweep(setup.tcert, x, y, lips_box=False, chunk=32,
                              superchunk=2)
    assert [type(s) for s in got] == [SweepStats] * N_IMAGES
    for g, w, p in zip(got, want, plain):
        assert (g.image, g.n_violated, g.clean, g.certified) == \
            (w.image, w.n_violated, w.clean, w.certified)
        assert g.worst == pytest.approx(w.worst, abs=1e-4)
        assert g.n_violated <= p.n_violated and g.worst <= p.worst + 1e-5
        assert p.certified == bool(setup.res_c.certified[p.image])
        if setup.res_c.certified[g.image] or setup.res_l.certified[g.image]:
            assert g.certified
        if g.certified:
            assert setup.res_l.larger_T_certified[g.image]
    # the plain sweep's worst is the Certifier's CROWN worst
    np.testing.assert_allclose([p.worst for p in plain], setup.res_c.worst,
                               atol=1e-6)
    sk = np.array([True, False, True, True, True, True])
    part = hybrid_base_sweep(setup.tcert, x, y, skip=sk, chunk=32,
                             superchunk=2)
    assert [s.image for s in part] == [1]


def test_hybrid_base_sweep_nan_fails_closed(setup, monkeypatch):
    real = trefine._kernels

    def poisoned(cert, **kw):
        sweep_fn, step_fn = real(cert, **kw)
        return (lambda c, img: sweep_fn(c, img) * float("nan")), step_fn

    monkeypatch.setattr(trefine, "_kernels", poisoned)
    (s,) = hybrid_base_sweep(setup.tcert, setup.x[:1], setup.y[:1], chunk=32,
                             superchunk=2)
    assert s.worst == float("inf") and not s.certified
    assert s.n_violated == len(setup.tcert.grid)


def test_refine_skip_and_on_image_resume(setup, runs):
    full_cert, full, streamed = runs(streamed=True)
    assert streamed == full
    skip = np.zeros(N_IMAGES, bool)
    base = setup.res_c.certified.copy()
    for s in streamed:
        skip[s.image] = True
        base[s.image] |= s.certified
    re_cert, re_stats = refine_uncertified(
        setup.tcert, setup.x, setup.y, base, skip=skip, **BUDGETS)
    assert re_stats == []
    np.testing.assert_array_equal(re_cert, full_cert)
    # a partial skip processes the rest only
    skip[:3] = False
    _, part = refine_uncertified(setup.tcert, setup.x, setup.y,
                                 setup.res_c.certified, skip=skip, **BUDGETS)
    assert [s.image for s in part] == [0, 1, 2]
    assert [_fields(s) for s in part] == [_fields(s) for s in full[:3]]


def test_refine_order_schedules_but_does_not_change_verdicts(setup, runs):
    base_cert, base = runs()
    todo = [s.image for s in base]
    order = todo[::-1][:-1]
    seen = []
    ord_cert, _ = refine_uncertified(
        setup.tcert, setup.x, setup.y, setup.res_c.certified,
        clean=setup.res_c.clean, order=order,
        on_image=lambda s: seen.append(s.image), **BUDGETS)
    assert seen == order + [todo[0]]
    np.testing.assert_array_equal(ord_cert, base_cert)


def test_refine_image_time_budget(setup):
    new_cert, stats = refine_uncertified(
        setup.tcert, setup.x, setup.y, setup.res_c.certified,
        clean=setup.res_c.clean, image_seconds=0.0, **BUDGETS)
    for s in stats:
        assert s.base_violated > 0
        assert not s.certified and s.gave_up == "time_budget"
        assert s.boxes_evaluated == 0 and s.rounds == 0
    assert not new_cert.any()


def test_refine_collect_cap(setup, runs):
    _, stats = runs(collect_cap=8)
    for s in stats:
        assert (s.base_violated, s.certified, s.gave_up) == (
            -1, False, "collect_cap")
        assert s.pre_alpha_violated > 8


def test_refine_alpha_evaluator_sound_and_no_looser(setup, runs):
    plain_cert, _ = runs()
    a_cert, a_stats = runs(alpha_iters=1)
    assert (~plain_cert | a_cert).all()
    assert (~a_cert | setup.res_l.larger_T_certified).all()
    for s in a_stats:
        assert s.pre_alpha_violated >= s.base_violated >= 0


def test_run_certify_refine_json_matches_jax(setup, tmp_path, monkeypatch):
    # the JAX runner, with its model, checkpoint and dataset stubbed to the
    # tiny model and images, against the port's run_certify
    ds = types.SimpleNamespace(test_x=setup.x, test_y=setup.y)
    monkeypatch.setattr(jexperiment, "build_model", lambda cfg: setup.jmodel)
    monkeypatch.setattr(jexperiment, "_restore_params",
                        lambda cfg, model, run_dir: setup.params)
    monkeypatch.setattr(jexperiment, "_load_cfg_dataset", lambda cfg: ds)
    cfg = {"T": T, "eps": EPS_INPUT, "chunk": BUDGETS["chunk"],
           "start_ind": 1, "end_ind": 4, "refine_rounds": 3,
           "module": {"dynamics": {"scale_nominal": False}}}
    jlog, tlog = str(tmp_path / "j.jsonl"), str(tmp_path / "t.jsonl")
    jres = jexperiment.run_certify(cfg, "crown", stream_out=jlog)
    tres = run_certify(setup.tmodel, setup.x, setup.y, "crown", T=T,
                       eps=EPS_INPUT, chunk=BUDGETS["chunk"], start_ind=1,
                       max_images=3, stream_out=tlog, refine_rounds=3)
    np.testing.assert_array_equal(tres.certified, jres.certified)
    want = json.loads(open(jlog + ".refine.json").read())
    got = json.loads(open(tlog + ".refine.json").read())
    assert list(got) == list(want)
    assert got["certified_idx"] == want["certified_idx"]
    assert got["certified_idx"], "the case certifies something"
    for key in ("refine_rounds", "start_ind", "recovered"):
        assert got[key] == want[key]
    timing = {"seconds"}
    assert ([{k: v for k, v in s.items() if k not in timing}
             for s in got["stats"]]
            == [{k: v for k, v in s.items() if k not in timing}
                for s in want["stats"]])
    assert min(s["image"] for s in got["stats"]) >= 1
