"""The certification slice as a whole against the JAX package (CPU): a tiny
model (TinyMLP backbone, n = 5, mlp 16) with the JAX parameters bridged into
the port, T = 10 (65 grid cells), the same numpy images through both
``Certifier``s.

Per-image worst values (the full sweep's max over cells, read from the JAX
package's jitted block functions with no early exit) agree within
WORST_TOL = 1e-4 and the verdicts are equal, for CROWN, Lipschitz, larger-T,
alpha-CROWN with both objectives, ``exact_witness``, scale_nominal on and
off, the two-sided QP, and chunk sizes that leave a padded last block.  A
log written by ``certify_stream`` folds to the same summary under both
packages' ``summarize_stream``.  The sweeps run with TF32 off and restore
the process-wide switches.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fiode_tpu.models.backbones import TinyMLPBackbone as JaxTinyMLP
from fiode_tpu.models.dynamics import SimplexDynamics as JaxDynamics
from fiode_tpu.models.ivp import NeuralODEClassifier as JaxClassifier
from fiode_tpu.verify.certify import Certifier as JaxCertifier
from fiode_tpu.verify.certify import summarize_stream as jax_summarize
from fiode_tpu_torch import params_from_numpy
from fiode_tpu_torch.models.backbones import TinyMLPBackbone
from fiode_tpu_torch.models.dynamics import SimplexDynamics
from fiode_tpu_torch.models.ivp import NeuralODEClassifier
from fiode_tpu_torch.verify import certify as tcertify
from fiode_tpu_torch.verify.certify import Certifier, summarize_stream
from fiode_tpu_torch.verify.grid import count_decision_boundary

N, X_DIM, MLP, HIDDEN, T = 5, 6, 16, 16, 10
N_IMAGES, MAX_STEPS = 6, 32
EPS_INPUT = 0.1
# float32 round-off of two frameworks' products, exps and 30-step bisections
# on the same cells, through a max over cells
WORST_TOL = 1e-4

# name -> Certifier keywords (both packages take the same)
CONFIGS = {
    "plain": dict(chunk=8),
    "padded_blocks": dict(chunk=3),  # 65 cells = one 48-cell block + 17 of 48
    "scale_nominal": dict(chunk=8, scale_nominal=True),
    "with_upper": dict(chunk=8, with_upper=True),
    "alpha_vdot": dict(chunk=8, alpha_iters=2, alpha_objective="vdot"),
    "alpha_width": dict(chunk=8, alpha_iters=2, alpha_objective="width"),
}
EXACT_CONFIGS = ("plain", "padded_blocks", "scale_nominal")


@pytest.fixture(scope="module")
def models():
    jmodel = JaxClassifier(
        backbone=JaxTinyMLP(out_dim=X_DIM, hidden=HIDDEN, mu=(0.5,),
                            std=(0.25,)),
        dynamics=JaxDynamics(n_hidden=N, mlp_size=MLP, x_dim=X_DIM,
                             dropout=0.0, alpha_1=100.0, alpha_2=20.0,
                             sigma_1=0.02, cayley=True),
        n_classes=N, max_steps=MAX_STEPS,
    )
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(N_IMAGES, 1, 8, 8)).astype(np.float32)
    params = jmodel.init(jax.random.PRNGKey(1), jnp.asarray(x))
    tmodel = NeuralODEClassifier(
        TinyMLPBackbone(64, out_dim=X_DIM, hidden=HIDDEN, mu=(0.5,),
                        std=(0.25,)),
        SimplexDynamics(n_hidden=N, mlp_size=MLP, x_dim=X_DIM, dropout=0.0,
                        alpha_1=100.0, alpha_2=20.0, sigma_1=0.02),
        max_steps=MAX_STEPS,
    ).eval()
    params_from_numpy(tmodel, jax.tree_util.tree_map(np.asarray, params))
    pred = np.asarray(jnp.argmax(jmodel.predict(params, jnp.asarray(x)), -1))
    y = pred.copy()
    y[-1] = (y[-1] + 1) % N  # one image that is not clean
    return jmodel, params, tmodel, x, y


@pytest.fixture(scope="module")
def certifiers(models):
    jmodel, params, tmodel, _, _ = models
    cache = {}

    def get(name):
        if name not in cache:
            kw = dict(T=T, eps_input=EPS_INPUT, **CONFIGS[name])
            cache[name] = (JaxCertifier(jmodel, params, **kw),
                           Certifier(tmodel, **kw))
        return cache[name]

    return get


def _jax_worst(cert, x, y, method):
    """The JAX certifier's per-image worst values over the whole grid (no
    early exit), NaN where the image is not clean: its own block functions
    driven as ``Certifier.certify`` drives them."""
    preds = np.asarray(cert._predict(cert.params, jnp.asarray(x)))
    clean = preds == y
    idx = np.nonzero(clean)[0]
    feats = jnp.asarray(np.asarray(cert._features(cert.params,
                                                  jnp.asarray(x)))[idx])
    labs = y[idx].astype(np.int32)
    perms = np.tile(np.arange(cert.n, dtype=np.int32), (len(idx), 1))
    perms[np.arange(len(idx)), 0] = labs
    perms[np.arange(len(idx)), labs] = 0
    start = jnp.full(len(idx), -jnp.inf, jnp.float32)
    if method == "crown":
        x_biases = feats @ jnp.asarray(cert.U).T + jnp.asarray(cert.bU)
        worst = start
        for etas, valids in cert._iter_chunks():
            worst = cert._crown_chunk(
                [jnp.asarray(W) for W in cert.Ws],
                [jnp.asarray(b) for b in cert.bs], x_biases,
                jnp.asarray(labs), jnp.asarray(perms), etas, valids, worst)
        worst = (worst,)
    else:
        worst = (start, start)
        for etas, valids in cert._iter_chunks():
            worst = cert._lips_chunk(cert.params, feats, jnp.asarray(labs),
                                     jnp.asarray(perms), etas, valids, worst)
    out = []
    for w in worst:
        full = np.full(len(x), np.nan, np.float32)
        full[idx] = np.asarray(w)
        out.append(full)
    return clean, out


@pytest.mark.parametrize("name", list(CONFIGS))
def test_crown_worst_values_and_verdicts_match_jax(models, certifiers, name):
    _, _, _, x, y = models
    jcert, tcert = certifiers(name)
    clean, (want,) = _jax_worst(jcert, x, y, "crown")
    res = tcert.certify(x, y, method="crown", early_exit=False)
    np.testing.assert_array_equal(res.clean, clean)
    assert clean.sum() == N_IMAGES - 1
    np.testing.assert_allclose(res.worst, want, atol=WORST_TOL)
    jres = jcert.certify(x, y, method="crown")
    np.testing.assert_array_equal(res.certified, jres.certified)
    assert res.cells_per_image == jres.cells_per_image \
        == count_decision_boundary(N, T)
    assert res.cells_checked == int(clean.sum()) * res.cells_per_image
    assert (~res.certified | res.clean).all()
    assert not res.larger_T_certified.any()


@pytest.mark.parametrize("name", EXACT_CONFIGS)
def test_lipschitz_and_larger_T_match_jax(models, certifiers, name):
    _, _, _, x, y = models
    jcert, tcert = certifiers(name)
    clean, (want_full, want_exact) = _jax_worst(jcert, x, y, "lipschitz")
    res = tcert.certify(x, y, method="lipschitz", early_exit=False)
    np.testing.assert_array_equal(res.clean, clean)
    np.testing.assert_allclose(res.worst, want_full, atol=WORST_TOL)
    np.testing.assert_allclose(res.worst_larger_T, want_exact, atol=WORST_TOL)
    jres = jcert.certify(x, y, method="lipschitz")
    np.testing.assert_array_equal(res.certified, jres.certified)
    np.testing.assert_array_equal(res.larger_T_certified,
                                  jres.larger_T_certified)
    # dropping the grid-gap slack can only help; certified implies clean
    assert (~res.certified | res.larger_T_certified).all()
    assert (~res.larger_T_certified | res.clean).all()
    # a CROWN-certified image has no positive exact value on the grid
    crown = tcert.certify(x, y, method="crown")
    assert (~crown.certified | res.larger_T_certified).all()


@pytest.mark.parametrize("name", EXACT_CONFIGS)
def test_exact_witness_matches_jax_and_larger_T(models, certifiers, name):
    _, _, _, x, y = models
    jcert, tcert = certifiers(name)
    want_v, want_i, want_clean = jcert.exact_witness(x, y)
    vals, idxs, clean = tcert.exact_witness(x, y)
    np.testing.assert_array_equal(clean, want_clean)
    np.testing.assert_allclose(vals, want_v, atol=WORST_TOL)
    # the argmax cell agrees wherever the runner-up is clearly behind
    res = tcert.certify(x, y, method="lipschitz", early_exit=False)
    np.testing.assert_allclose(vals[clean], res.worst_larger_T[clean],
                               atol=1e-6)
    assert ((idxs >= 0) & (idxs < len(tcert.grid))).all()
    same = idxs == want_i
    assert same.mean() >= 0.5


@pytest.mark.parametrize("scale_nominal", [False, True])
def test_groupsort_lipschitz_sweep_matches_jax(scale_nominal):
    # the exact field of GroupSort dynamics is their eval_dot, as in the JAX
    # package's Lipschitz chunk, not the ReLU field K1 computes
    kw = dict(n_hidden=N, mlp_size=MLP, x_dim=X_DIM, dropout=0.0,
              activation="GroupSort", alpha_1=100.0, alpha_2=20.0,
              sigma_1=0.02)
    jmodel = JaxClassifier(
        backbone=JaxTinyMLP(out_dim=X_DIM, hidden=HIDDEN, mu=(0.5,),
                            std=(0.25,)),
        dynamics=JaxDynamics(cayley=True, **kw), n_classes=N,
        max_steps=MAX_STEPS)
    x = np.random.default_rng(3).uniform(size=(4, 1, 8, 8)).astype(np.float32)
    params = jmodel.init(jax.random.PRNGKey(4), jnp.asarray(x))
    tmodel = NeuralODEClassifier(
        TinyMLPBackbone(64, out_dim=X_DIM, hidden=HIDDEN, mu=(0.5,),
                        std=(0.25,)),
        SimplexDynamics(**kw), max_steps=MAX_STEPS).eval()
    params_from_numpy(tmodel, jax.tree_util.tree_map(np.asarray, params))
    y = np.array(jnp.argmax(jmodel.predict(params, jnp.asarray(x)), -1))
    ckw = dict(T=8, eps_input=EPS_INPUT, chunk=8, scale_nominal=scale_nominal)
    jcert = JaxCertifier(jmodel, params, **ckw)
    tcert = Certifier(tmodel, **ckw)
    clean, (want_full, want_exact) = _jax_worst(jcert, x, y, "lipschitz")
    before = tcertify.fused_rhs.launches
    res = tcert.certify(x, y, method="lipschitz", early_exit=False)
    assert tcertify.fused_rhs.launches == before
    np.testing.assert_array_equal(res.clean, clean)
    assert clean.all()
    np.testing.assert_allclose(res.worst, want_full, atol=WORST_TOL)
    np.testing.assert_allclose(res.worst_larger_T, want_exact, atol=WORST_TOL)
    jres = jcert.certify(x, y, method="lipschitz", early_exit=False)
    np.testing.assert_array_equal(res.certified, jres.certified)
    np.testing.assert_array_equal(res.larger_T_certified,
                                  jres.larger_T_certified)
    # the exact field differs from the ReLU field of the same weights
    p, rows = tcert.rhs_rows(tmodel.features(torch.from_numpy(x[:1])), 3)
    assert p is None
    h = torch.from_numpy(tcert.grid[:3])
    relu = tcertify.fused_rhs(
        h, (rows @ tcert.U.T + tcert.bU + tcert.bs[0]).contiguous(),
        tcertify.pack_rhs_params(*tcert.Ws, *tcert.bs[1:]), 100.0, 0.02, 20.0,
        scale_nominal)
    assert not torch.allclose(tcert.exact_field(p, rows, h), relu, atol=1e-3)


def test_scale_nominal_widens_lipschitz_kappa(certifiers):
    _, off = certifiers("plain")
    joff, _ = certifiers("plain")
    jon, on = certifiers("scale_nominal")
    assert off.kappa_lips == off.kappa == pytest.approx(joff.kappa, rel=1e-12)
    assert on.kappa == off.kappa  # CROWN's kappa is unconditional
    assert on.kappa_lips == pytest.approx(100.0 * off.kappa, rel=1e-12)
    assert on.kappa_lips == pytest.approx(jon.kappa_lips, rel=1e-12)


@pytest.mark.parametrize("name", ["alpha_vdot", "alpha_width"])
def test_alpha_crown_never_looser_than_plain(models, certifiers, name):
    _, _, _, x, y = models
    _, plain = certifiers("plain")
    _, alpha = certifiers(name)
    rp = plain.certify(x, y, method="crown", early_exit=False)
    ra = alpha.certify(x, y, method="crown", early_exit=False)
    clean = rp.clean
    assert (ra.worst[clean] <= rp.worst[clean] + 1e-6).all()
    assert (~rp.certified | ra.certified).all()


def test_early_exit_keeps_verdicts(models, certifiers):
    _, _, _, x, y = models
    _, tcert = certifiers("padded_blocks")
    for method in ("crown", "lipschitz"):
        full = tcert.certify(x, y, method=method, early_exit=False)
        fast = tcert.certify(x, y, method=method, early_exit=True)
        np.testing.assert_array_equal(full.certified, fast.certified)
        np.testing.assert_array_equal(full.larger_T_certified,
                                      fast.larger_T_certified)
        assert fast.cells_checked <= full.cells_checked


@pytest.mark.parametrize("method", ["crown", "lipschitz"])
def test_stream_log_folds_the_same_in_both_packages(models, certifiers,
                                                    tmp_path, method):
    _, _, _, x, y = models
    jcert, tcert = certifiers("plain")
    tlog, jlog = tmp_path / "t.jsonl", tmp_path / "j.jsonl"
    tres = tcert.certify_stream(x, y, method=method, image_batch=4,
                                out_path=str(tlog), start_ind=100)
    jres = jcert.certify_stream(x, y, method=method, image_batch=4,
                                out_path=str(jlog), start_ind=100)
    batch = tcert.certify(x, y, method=method)
    np.testing.assert_array_equal(tres.certified, batch.certified)
    np.testing.assert_array_equal(tres.clean, batch.clean)
    # the same lines and summary, field for field
    tlines = [json.loads(line) for line in tlog.read_text().splitlines()]
    jlines = [json.loads(line) for line in jlog.read_text().splitlines()]
    assert len(tlines) == len(jlines) == 2
    timing = {"seconds", "cells_per_sec"}
    for a, b in zip(tlines, jlines):
        assert a.keys() == b.keys()
        assert ({k: v for k, v in a.items() if k not in timing}
                == {k: v for k, v in b.items() if k not in timing})
    tsum = json.loads((tmp_path / "t.jsonl.json").read_text())
    jsum = json.loads((tmp_path / "j.jsonl.json").read_text())
    assert list(tsum) == list(jsum)
    assert ({k: v for k, v in tsum.items() if k not in timing}
            == {k: v for k, v in jsum.items() if k not in timing})
    assert tsum["matmul_precision"] == "float32"
    # either package's summarize_stream folds either package's log
    folds = [fold(str(log)) for fold in (summarize_stream, jax_summarize)
             for log in (tlog, jlog)]
    for f in folds:
        assert ({k: v for k, v in f.items() if k not in timing}
                == {k: v for k, v in folds[0].items() if k not in timing})
    assert folds[0]["n_images"] == N_IMAGES
    assert folds[0]["index_min"] == 100
    assert ("larger_T_certified_idx" in folds[0]) == (method == "lipschitz")


def test_summarize_stream_merges_resumed_segments(tmp_path):
    log = tmp_path / "s.jsonl"
    recs = [
        {"idx_from": 0, "idx_to": 3, "clean": 4, "certified": 2, "n": 4,
         "batch_certified_idx": [0, 2], "cells_checked": 40, "seconds": 1.0,
         "matmul_precision": "float32"},
        {"idx_from": 4, "idx_to": 7, "clean": 7, "certified": 3, "n": 8,
         "batch_certified_idx": [5], "cells_checked": 70, "seconds": 2.0,
         "matmul_precision": "float32"},
        # a resumed run: its counters restart
        {"idx_from": 8, "idx_to": 11, "clean": 3, "certified": 3, "n": 4,
         "batch_certified_idx": [8, 9, 11], "cells_checked": 30,
         "seconds": 0.5, "matmul_precision": "float32"},
    ]
    log.write_text("".join(json.dumps(r) + "\n" for r in recs))
    got = summarize_stream(str(log))
    assert got == jax_summarize(str(log))
    assert (got["segments"], got["n_images"], got["clean"],
            got["certified"], got["cells_checked"]) == (2, 12, 10, 6, 100)
    assert got["certified_idx"] == [0, 2, 5, 8, 9, 11]


def test_sweeps_run_with_tf32_off_and_restore_it(models, certifiers,
                                                 monkeypatch):
    _, _, _, x, y = models
    _, tcert = certifiers("plain")
    seen = []
    real_crown, real_rhs = tcertify.crown_mlp_bounds, tcertify.fused_rhs

    def flags():
        seen.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32))

    def spy_crown(*args, **kw):
        flags()
        return real_crown(*args, **kw)

    def spy_rhs(*args, **kw):
        flags()
        return real_rhs(*args, **kw)

    monkeypatch.setattr(tcertify, "crown_mlp_bounds", spy_crown)
    monkeypatch.setattr(tcertify, "fused_rhs", spy_rhs)
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    try:
        for setting in ((True, True), (False, True)):
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = setting
            seen.clear()
            tcert.certify(x, y, method="crown")
            tcert.certify(x, y, method="lipschitz")
            tcert.exact_witness(x, y)
            assert len(seen) >= 3 and set(seen) == {(False, False)}
            assert (torch.backends.cuda.matmul.allow_tf32,
                    torch.backends.cudnn.allow_tf32) == setting
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = before


@pytest.mark.parametrize("method", ["crown", "lipschitz"])
def test_no_clean_image_sweeps_nothing(models, certifiers, method):
    _, _, _, x, y = models
    _, tcert = certifiers("plain")
    res = tcert.certify(x[-1:], y[-1:], method=method)  # the mislabelled one
    assert not res.clean.any() and not res.certified.any()
    assert not res.larger_T_certified.any()
    assert res.cells_checked == 0 and np.isnan(res.worst).all()


def test_run_certify_streams_and_refuses_refinement(models, tmp_path):
    from fiode_tpu_torch.experiment import run_certify, run_sample_grid
    _, _, tmodel, x, y = models
    grid = run_sample_grid(N, T, out_path=str(tmp_path / "grid.npy"))
    assert grid.shape == (count_decision_boundary(N, T), N)
    np.testing.assert_array_equal(np.load(tmp_path / "grid.npy"), grid)
    log = tmp_path / "run.jsonl"
    res = run_certify(tmodel, x, y, "lipschitz", T=T, eps=EPS_INPUT, chunk=8,
                      grid=grid, start_ind=1, max_images=4,
                      stream_out=str(log))
    assert len(res.clean) == 4
    lines = [json.loads(line) for line in log.read_text().splitlines()]
    assert [(r["idx_from"], r["idx_to"]) for r in lines] == [(1, 4)]
    summary = json.loads((tmp_path / "run.jsonl.json").read_text())
    assert summary["start_ind"] == 1 and summary["method"] == "lipschitz"
    want = Certifier(tmodel, T=T, eps_input=EPS_INPUT, chunk=8).certify(
        x[1:5], y[1:5], method="lipschitz")
    np.testing.assert_array_equal(res.certified, want.certified)
    np.testing.assert_array_equal(res.larger_T_certified,
                                  want.larger_T_certified)
    # refinement is not refused: it runs after the sweep, folds what it
    # recovers into the verdicts and writes its audit file beside the log
    rlog = tmp_path / "refine.jsonl"
    base = run_certify(tmodel, x, y, "crown", T=T, eps=EPS_INPUT, chunk=8,
                       grid=grid, stream_out=str(rlog))
    refined = run_certify(tmodel, x, y, "crown", T=T, eps=EPS_INPUT, chunk=8,
                          grid=grid, refine_rounds=1, stream_out=str(rlog))
    assert (~base.certified | refined.certified).all()
    audit = json.loads((tmp_path / "refine.jsonl.refine.json").read_text())
    assert audit["refine_rounds"] == 1
    assert audit["certified_idx"] == np.nonzero(refined.certified)[0].tolist()
    assert [s["image"] for s in audit["stats"]] == \
        np.nonzero(base.clean & ~base.certified)[0].tolist()


def test_truncated_clean_solve_raises(models):
    _, _, tmodel, x, y = models
    tcert = Certifier(tmodel, T=T, eps_input=EPS_INPUT, chunk=8)
    saved = tmodel.max_steps
    tmodel.max_steps = 1
    try:
        with pytest.raises(RuntimeError, match="max_steps"):
            tcert.certify(x, y, method="crown")
    finally:
        tmodel.max_steps = saved


def test_bad_arguments_rejected(models):
    _, _, tmodel, x, y = models
    with pytest.raises(ValueError):
        Certifier(tmodel, T=T, grid=np.zeros((0, N), np.float32))
    with pytest.raises(ValueError):
        Certifier(tmodel, T=T, alpha_objective="loss")
    with pytest.raises(ValueError):
        Certifier(tmodel, T=T, chunk=8).certify(x, y, method="ibp")
