"""The port's trainer (fiode_tpu_torch.train.trainer) on the CPU, mirroring
the JAX package's tests/test_training.py, tests/test_train_modes.py and
tests/test_logging.py: the loss falls, checkpoints round-trip, the best
watermark survives a reopen, a resumed run equals the uninterrupted one bit
for bit, evaluation covers the tail batch and integrates the phase's field,
the adversarial, Lipschitz-aware, ODE and classical modes run; dropout draws
its mask from the caller's generator; run_train on a composed config trains,
checkpoints and evaluates, and its best checkpoint loads back.  The new
layers (LipsLinear dynamics, the plain CNN backbone) are held against the
JAX package at 1e-5."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fiode_tpu.models.backbones import PlainCNNBackbone as JaxPlainCNN
from fiode_tpu.models.dynamics import SimplexDynamics as JaxDynamics
from fiode_tpu_torch.bridge import params_from_numpy, params_to_numpy
from fiode_tpu_torch.experiment import build_model, run_train
from fiode_tpu_torch.models.backbones import PlainCNNBackbone, TinyMLPBackbone
from fiode_tpu_torch.models.dynamics import SimplexDynamics
from fiode_tpu_torch.models.ivp import NeuralODEClassifier
from fiode_tpu_torch.train.data import load_dataset
from fiode_tpu_torch.train.schedulers import (
    CompositeSamplerScheduler,
    LinearScheduler,
)
from fiode_tpu_torch.train.trainer import LyapunovTrainer, TrainConfig
from fiode_tpu_torch.utils.checkpoint import CheckpointManager
from fiode_tpu_torch.utils.config import compose
from fiode_tpu_torch.utils.logging import MetricWriter


def make_trainer(tmp_path, cayley=True, scale_nominal=True, size=256,
                 device="cpu", **cfg_kw):
    ds = load_dataset("MNIST", data_root=str(tmp_path / "nope"),
                      synthetic_size=size)
    assert ds.synthetic
    g = torch.Generator().manual_seed(0)
    dyn = SimplexDynamics(n_hidden=10, mlp_size=16, x_dim=10, dropout=0.1,
                          kappa=2.0, cayley=cayley,
                          scale_nominal=scale_nominal, generator=g)
    model = NeuralODEClassifier(
        TinyMLPBackbone(784, out_dim=10, hidden=16, mu=(0.1307,),
                        std=(0.3081,), generator=g),
        dyn, max_steps=64)
    sch = CompositeSamplerScheduler(
        [LinearScheduler(rate=-0.02, bias=1.0, clamp="min", clamp_val=0.02,
                         start=10),
         LinearScheduler(rate=0.02, clamp="max", clamp_val=0.98, start=10)],
        [1.0, 1.0])
    cfg = TrainConfig(**dict(dict(batch_size=32, val_batch_size=64,
                                  h_sample_size=8, max_epochs=3, lr=5e-3,
                                  log_every=2), **cfg_kw))
    return LyapunovTrainer(model, cfg, ds, scheduler=sch,
                           run_dir=str(tmp_path / "run"), device=device)


def records(tmp_path):
    return [json.loads(l) for l in open(tmp_path / "run" / "metrics.jsonl")]


def test_loss_decreases(tmp_path):
    tr = make_trainer(tmp_path, size=512)
    tr.fit(epochs=2)
    losses = torch.cat(tr.losses)
    assert len(losses) == 2 * 14
    assert losses[-4:].mean() < losses[:4].mean(), losses
    logged = [r["training_loss"] for r in records(tmp_path)
              if "training_loss" in r]
    assert len(logged) == 14 and np.isfinite(logged).all()
    vals = [r for r in records(tmp_path) if "validation_error" in r]
    assert len(vals) == 2 and vals[-1]["validation_error"] <= 0.95


def test_checkpoint_roundtrip(tmp_path):
    tr = make_trainer(tmp_path)
    model = tr.fit(epochs=1)
    fresh = make_trainer(tmp_path / "other").model
    tr.ckpt.restore(fresh, "last")
    for a, b in zip(model.parameters(), fresh.parameters()):
        assert torch.equal(a, b)
    best = json.loads((tr.ckpt.dir / "best.json").read_text())
    assert best["step"] == 7 and "validation_error" in best


def test_best_watermark_survives_reopen(tmp_path):
    model = torch.nn.Linear(2, 1)
    m1 = CheckpointManager(str(tmp_path))
    assert m1.maybe_save_best(model, {"validation_error": 0.5}, 0)
    m2 = CheckpointManager(str(tmp_path))
    assert m2.best == 0.5
    assert not m2.maybe_save_best(model, {"validation_error": 0.7}, 1)
    assert m2.maybe_save_best(model, {"validation_error": 0.4}, 2)
    assert json.loads((tmp_path / "ckpt" / "best.json").read_text())["step"] == 2


def test_resume_matches_uninterrupted(tmp_path):
    """Stopping after epoch 1 and resuming replays the uninterrupted run bit
    for bit: weights, optimizer state, generator states and the batch
    order are restored."""
    full = make_trainer(tmp_path / "full").fit(epochs=3)
    make_trainer(tmp_path / "part").fit(epochs=2)
    resumed = make_trainer(tmp_path / "part").fit(epochs=3, resume=True)
    for a, b in zip(full.parameters(), resumed.parameters()):
        assert torch.equal(a, b)


def test_evaluate_covers_tail_batch(tmp_path):
    tr = make_trainer(tmp_path)
    n = len(tr.ds.test_x)
    bs = n // 2 + 3
    tr.cfg = dataclasses.replace(tr.cfg, val_batch_size=bs)
    seen = []

    def fake_eval_step(bx, by, **kw):
        seen.append(int(bx.shape[0]))
        return {"batch_len": float(bx.shape[0])}

    tr._eval_step = fake_eval_step
    out = tr.evaluate(split="test")
    assert seen == [bs, n - bs]
    assert abs(out["batch_len"] - (bs ** 2 + (n - bs) ** 2) / n) < 1e-6


def test_eval_follows_training_phase_scale_nominal(tmp_path):
    tr = make_trainer(tmp_path, epoch_off_scale=0)
    tr.fit(epochs=1)
    assert tr._phase_scale_nominal is False
    default = tr.evaluate()
    off = tr.evaluate(scale_nominal=False)
    on = tr.evaluate(scale_nominal=True)
    assert default["validation_loss"] == off["validation_loss"]
    assert on["validation_loss"] != off["validation_loss"]


def test_adv_train_step_runs(tmp_path):
    tr = make_trainer(tmp_path, adv_train=True, val_adv=True, size=128)
    tr.fit(epochs=1)
    assert tr.ckpt.monitor == "validation_adv_error"
    vals = [r for r in records(tmp_path) if "validation_adv_error" in r]
    assert vals and vals[-1]["validation_adv_error"] >= vals[-1]["validation_error"]
    assert all(torch.isfinite(l).all() for l in tr.losses)


def test_test_autoattack_runs(tmp_path):
    tr = make_trainer(tmp_path, size=64)
    tr.fit(epochs=1)
    t_max = tr.model.t_max
    out = tr.test_autoattack(attacks=("apgd-ce",), max_batches=1, n_iter=2,
                             t_max=0.1, max_steps=16,
                             generator=torch.Generator().manual_seed(0))
    assert out["n_images"] == 64 and tr.model.t_max == t_max
    assert 0.0 <= out["test_error_clean"] <= out["test_error_adv"] <= 1.0
    assert len(out["robust_idx"]) == round(64 * (1 - out["test_error_adv"]))


def test_lips_train_step_runs(tmp_path):
    tr = make_trainer(tmp_path, cayley=False, scale_nominal=False,
                      lips_train=True, lips_warmup=0)
    tr.fit(epochs=1)
    recs = records(tmp_path)
    lips = [r["Lips"] for r in recs if "Lips" in r]
    kappas = [r["kappa"] for r in recs if "kappa" in r]
    assert lips and all(l > 0 for l in lips)
    assert kappas and all(k >= 1.0 for k in kappas)


@pytest.mark.parametrize("objective", ["ode", "classical"])
def test_objective_trains(tmp_path, objective):
    tr = make_trainer(tmp_path, cayley=False, scale_nominal=False,
                      objective=objective, size=128)
    tr.fit(epochs=1)
    assert torch.isfinite(tr.losses[0]).all()
    vals = [r for r in records(tmp_path) if "val_nfe" in r]
    # the classical objective validates the backbone: no solve
    assert (vals[-1]["val_nfe"] == 0.0) == (objective == "classical")


def test_dropout_mask_from_the_generator():
    """train=True drops activations with a mask drawn from the caller's
    generator and scales the kept ones by 1 / keep; the same generator
    state gives the same mask, and the solve never drops."""
    dyn = SimplexDynamics(n_hidden=4, mlp_size=64, x_dim=3, dropout=0.25,
                          generator=torch.Generator().manual_seed(0))
    z = torch.ones(2000, 64)
    g = torch.Generator().manual_seed(5)
    out = dyn._drop(z, True, g)
    kept = out != 0
    assert torch.allclose(out[kept], torch.full_like(out[kept], 1 / 0.75))
    assert abs(kept.float().mean().item() - 0.75) < 0.01
    again = dyn._drop(z, True, torch.Generator().manual_seed(5))
    assert torch.equal(out, again)
    assert torch.equal(dyn._drop(z, False, g), z)
    h = torch.full((5, 4), 0.25)
    x = torch.rand(5, 3, generator=torch.Generator().manual_seed(1))
    a = dyn.eval_dot(h, x, train=True, generator=torch.Generator().manual_seed(2))
    b = dyn.eval_dot(h, x, train=True, generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, dyn.eval_dot(h, x))


def test_lips_dynamics_match_jax():
    """cayley=False (LipsLinear layers) against the JAX module, eval_dot
    and raw at 1e-5."""
    jd = JaxDynamics(n_hidden=10, mlp_size=16, x_dim=6, dropout=0.0,
                     cayley=False, scale_nominal=True)
    rng = np.random.default_rng(0)
    h = rng.dirichlet(np.ones(10), 7).astype(np.float32)
    x = rng.normal(size=(7, 6)).astype(np.float32)
    params = jd.init(jax.random.PRNGKey(0), jnp.asarray(h), jnp.asarray(x),
                     method=jd.eval_dot)["params"]
    td = SimplexDynamics(n_hidden=10, mlp_size=16, x_dim=6, dropout=0.0,
                         cayley=False, scale_nominal=True)
    params_from_numpy(td, jax.tree_util.tree_map(np.asarray, params))
    for method in ("eval_dot", "raw"):
        want = jd.apply({"params": params}, jnp.asarray(h), jnp.asarray(x),
                        method=getattr(jd, method))
        got = getattr(td, method)(torch.from_numpy(h), torch.from_numpy(x))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=0, atol=1e-5)
    back = params_to_numpy(td)
    assert set(back) == {"hidden_to_mlp", "U_x", "mlp_to_mlp", "mlp_to_hidden"}
    assert set(back["U_x"]) == {"kernel", "bias"}


@pytest.mark.parametrize("arch", ["4C3F", "6C2F"])
def test_plain_cnn_matches_jax(arch):
    jb = JaxPlainCNN(arch=arch, out_dim=10, act="ReLU", mu=(0.5,) * 3,
                     std=(0.25,) * 3)
    x = np.random.default_rng(1).uniform(size=(2, 3, 8, 8)).astype(np.float32)
    params = jax.jit(jb.init)(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    want = jax.jit(jb.apply)({"params": params}, jnp.asarray(x))
    tb = PlainCNNBackbone(arch, out_dim=10, act="ReLU", mu=(0.5,) * 3,
                          std=(0.25,) * 3, img_size=8)
    params_from_numpy(tb, jax.tree_util.tree_map(np.asarray, params))
    got = tb(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)


def test_run_train_composed_config(tmp_path):
    """run_train on cifar_train.yaml cut to a tiny width: trains 2 epochs
    (augmentation on), validates and checkpoints each, evaluates on the
    test split; the best checkpoint loads into a fresh build_model and
    reproduces its recorded validation error; a resumed run ends where
    the uninterrupted one did."""
    ov = ["++synthetic_size=64", "++batch_size=8", "++val_batch_size=16",
          "++module.h_sample_size=4", "++module.dynamics.mlp_size=16",
          "+module/init_fun/param_map@module.init_fun.param_map=TinyMLP",
          f"++data_root={tmp_path / 'nodata'}"]
    cfg = compose("cifar_train.yaml", ov, config_dir="configs/classification")
    tr, test = run_train(cfg, run_dir=str(tmp_path / "a"), epochs=2,
                         device="cpu")
    assert tr.steps_per_epoch == 8 and len(tr.losses) == 2
    assert np.isfinite(test["validation_loss"])
    recs = [json.loads(l) for l in open(tmp_path / "a" / "metrics.jsonl")]
    assert any("test_validation_error" in r for r in recs)
    best = json.loads((tr.ckpt.dir / "best.json").read_text())
    model = build_model(cfg, device="cpu")
    tr.ckpt.restore(model, "best")
    x = torch.from_numpy(tr.ds.val_x)
    pred = model.solve(x, scale_nominal=True).ys[-1].argmax(-1).numpy()
    assert abs((pred != tr.ds.val_y).mean() - best["validation_error"]) < 1e-6

    run_train(cfg, run_dir=str(tmp_path / "b"), epochs=1, device="cpu")
    tb, _ = run_train(cfg, run_dir=str(tmp_path / "b"), epochs=2,
                      resume=True, device="cpu")
    for a, b in zip(tr.model.parameters(), tb.model.parameters()):
        assert torch.equal(a, b)


def test_trainer_refuses_a_missing_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((RuntimeError, AssertionError)):
        make_trainer(tmp_path, device="cuda")


# -- MetricWriter (tests/test_logging.py) -------------------------------------

def test_metrics_jsonl_append_and_fields(tmp_path):
    w = MetricWriter(str(tmp_path), config={"lr": 5e-3})
    w.log({"training_loss": torch.tensor(1.5)}, step=0, epoch=0)
    w.log({"training_loss": 1.25}, step=1, epoch=0)
    recs = [json.loads(l) for l in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [0, 1]
    assert recs[0]["training_loss"] == 1.5 and recs[1]["training_loss"] == 1.25
    assert recs[0]["epoch"] == 0


def test_config_write_once_preserves_training_record(tmp_path, capsys):
    MetricWriter(str(tmp_path), config={"max_epochs": 300})
    MetricWriter(str(tmp_path), config={"max_epochs": 10})
    assert json.loads((tmp_path / "config.json").read_text())["max_epochs"] == 300
    assert "WARNING" in capsys.readouterr().out


def test_config_rewrite_identical_is_silent(tmp_path, capsys):
    MetricWriter(str(tmp_path), config={"max_epochs": 300})
    MetricWriter(str(tmp_path), config={"max_epochs": 300})
    assert "WARNING" not in capsys.readouterr().out
