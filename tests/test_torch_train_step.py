"""One training step of the port (fiode_tpu_torch.train.trainer) against the
JAX package's ``LyapunovTrainer._train_step``, from the same weights (JAX's
init carried over with ``bridge.params_from_numpy``) and, for the Lyapunov
objective, the sampler draws JAX made (its key splits replayed); dropout 0
and no augmentation.  Then three steps of ``fit`` across the warmup
optimizer swap and the cosine schedule.

Tolerances:
  * loss: 1e-5 absolute for the Lyapunov and classical objectives, float32
    round-off of the two frameworks' sums; through the solve 5e-3 relative,
    the tolerance of the existing solve-gradient tests;
  * gradients, read from a step of SGD at learning rate 1 without momentum
    (the update is minus the gradient): 1e-6 absolute (float32 round-off of
    the sums and of p - g) for the Lyapunov and classical objectives, 5e-3
    relative to each tensor's largest entry through the solve;
  * Adam-updated weights: 1e-5 on every entry whose gradient is at least a
    hundred times the gradients' tolerance in size.  The first Adam update
    is lr g / (|g| + 1e-8): on an entry whose gradient is a cancellation
    within round-off of zero, either framework's round-off moves it by a
    visible share of lr (elsewhere both updates are at most lr).
"""
import copy
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fiode_tpu.models.backbones import TinyMLPBackbone as JaxTinyMLP
from fiode_tpu.models.dynamics import SimplexDynamics as JaxDynamics
from fiode_tpu.models.ivp import NeuralODEClassifier as JaxClassifier
from fiode_tpu.train.data import load_dataset as jax_load_dataset
from fiode_tpu.train.trainer import LyapunovTrainer as JaxTrainer
from fiode_tpu.train.trainer import TrainConfig as JaxConfig
from fiode_tpu_torch.bridge import params_from_numpy, params_to_numpy
from fiode_tpu_torch.models.backbones import TinyMLPBackbone
from fiode_tpu_torch.models.dynamics import SimplexDynamics
from fiode_tpu_torch.models.ivp import NeuralODEClassifier
from fiode_tpu_torch.train.data import load_dataset
from fiode_tpu_torch.train.trainer import LyapunovTrainer, TrainConfig

B, S, N, MLP, HIDDEN = 8, 4, 10, 16, 16
MU, STD = (0.1307,), (0.3081,)
MIXER = np.asarray([0.75, 0.25], np.float32)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _jax_model():
    return JaxClassifier(
        backbone=JaxTinyMLP(out_dim=10, hidden=HIDDEN, mu=MU, std=STD),
        dynamics=JaxDynamics(n_hidden=N, mlp_size=MLP, x_dim=10, dropout=0.0,
                             kappa=2.0, scale_nominal=True),
        n_classes=10, max_steps=64)


def _port_model():
    return NeuralODEClassifier(
        TinyMLPBackbone(784, out_dim=10, hidden=HIDDEN, mu=MU, std=STD),
        SimplexDynamics(n_hidden=N, mlp_size=MLP, x_dim=10, dropout=0.0,
                        kappa=2.0, scale_nominal=True),
        max_steps=64)


def _config(objective, opt_name, **kw):
    kw = dict(dict(batch_size=B, val_batch_size=16, h_sample_size=S,
                   max_epochs=3, lr=5e-3, augment=False, objective=objective,
                   opt_name=opt_name, momentum=0.0), **kw)
    if opt_name == "SGD":
        kw.update(lr=1.0, scheduler_name="none")
    return kw


def _jax_draws(key):
    """The sampler draws of JAX's step at ``key`` (trainer.py's splits:
    k_aug, k_adv, k_loss; k_samp, k_drop; one key per sampler)."""
    _, _, k_loss = jax.random.split(key, 3)
    k_samp, _ = jax.random.split(k_loss)
    return [(torch.from_numpy(np.array(
        jax.random.exponential(k, (B, S, N)))),)
        for k in jax.random.split(k_samp, 2)]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("nodata"))
    return (jax_load_dataset("MNIST", data_root=root, synthetic_size=64),
            load_dataset("MNIST", data_root=root, synthetic_size=64))


def _one_step(tmp_path, data, objective, opt_name):
    """(JAX loss, port loss, initial params, JAX params, port params, port
    gradients) after one step of each from JAX's init."""
    jds, tds = data
    kw = _config(objective, opt_name)
    jm = _jax_model()
    jtr = JaxTrainer(jm, JaxConfig(**kw), jds, run_dir=str(tmp_path / "jax"))
    x, y = jds.train_x[:B], jds.train_y[:B]
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    p0 = jax.tree_util.tree_map(np.asarray, params)
    key = jax.random.PRNGKey(7)
    new, _, _, jloss, _ = jtr._train_step(
        params, jtr.main_tx.init(params), None, key, jnp.asarray(x),
        jnp.asarray(y), jnp.asarray(0), jnp.asarray(MIXER), jnp.asarray(0.0),
        scale_nominal=True, use_warmup_tx=False)

    tm = params_from_numpy(_port_model(), p0)
    ttr = LyapunovTrainer(tm, TrainConfig(**kw), tds,
                          run_dir=str(tmp_path / "port"), device="cpu")
    ttr.reset_optimizer(False)
    draws = {"samples": _jax_draws(key)} if objective == "lyapunov" else None
    tloss, _ = ttr._train_step(torch.from_numpy(x), torch.from_numpy(y).long(),
                               0, MIXER, 0.0, True, draws=draws)
    return (float(jloss), float(tloss), _flat(p0),
            _flat(jax.tree_util.tree_map(np.asarray, new)),
            _flat(params_to_numpy(tm)), _grads(tm))


def _grads(model):
    """The model's gradients under the flax names of its parameters."""
    view = copy.deepcopy(model)
    with torch.no_grad():
        for p, q in zip(view.parameters(), model.parameters()):
            p.copy_(q.grad)
    return _flat(params_to_numpy(view))


@pytest.fixture(scope="module", params=["lyapunov", "ode", "classical"])
def steps(request, data, tmp_path_factory):
    """(objective, the SGD step's results, the Adam step's results)."""
    tmp = tmp_path_factory.mktemp(request.param)
    return (request.param,
            _one_step(tmp / "sgd", data, request.param, "SGD"),
            _one_step(tmp / "adam", data, request.param, "Adam"))


def _grad_tol(objective, g):
    return 5e-3 * max(np.abs(g).max(), 1e-6) if objective == "ode" else 1e-6


def test_one_step_gradients_match_jax(steps):
    objective, (jloss, tloss, p0, pj, pt, grads), _ = steps
    if objective == "ode":
        assert abs(jloss - tloss) <= 5e-3 * abs(jloss)
    else:
        assert abs(jloss - tloss) <= 1e-5
    for name in p0:
        g_jax = p0[name] - pj[name]
        np.testing.assert_allclose(grads[name], g_jax, rtol=0,
                                   atol=_grad_tol(objective, g_jax),
                                   err_msg=name)


def test_one_adam_step_matches_jax(steps):
    objective, (_, _, p0, pj_sgd, _, _), (jloss, tloss, _, pj, pt, _) = steps
    if objective == "ode":
        assert abs(jloss - tloss) <= 5e-3 * abs(jloss)
    else:
        assert abs(jloss - tloss) <= 1e-5
    for name in p0:
        g = p0[name] - pj_sgd[name]
        sized = np.abs(g) >= 100 * _grad_tol(objective, g)
        np.testing.assert_allclose(pt[name][sized], pj[name][sized], rtol=0,
                                   atol=1e-5, err_msg=name)
        # elsewhere an update is at most lr in size in both
        assert np.abs(pt[name] - pj[name]).max() <= 2 * 5e-3


def test_three_steps_across_warmup_and_cosine(tmp_path, data):
    """fit for three one-step epochs: epoch 0 on the warmup Adam(1e-3, wd
    5e-4), then the swap to a fresh main Adam whose cosine rate is read at
    its own update count (epochs 0 and 1 of the schedule); the classical
    objective's zero dynamics gradients still take the warmup's decay."""
    jds, tds = (dataclasses.replace(ds, train_x=ds.train_x[:B],
                                    train_y=ds.train_y[:B]) for ds in data)
    kw = _config("classical", "Adam", warmup=1, max_epochs=4, log_every=1)
    jm = _jax_model()
    jtr = JaxTrainer(jm, JaxConfig(**kw), jds, run_dir=str(tmp_path / "jax"))
    jparams = jtr.fit(epochs=3)
    init = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(jds.train_x[:B]))

    tm = params_from_numpy(_port_model(),
                           jax.tree_util.tree_map(np.asarray, init))
    ttr = LyapunovTrainer(tm, TrainConfig(**kw), tds,
                          run_dir=str(tmp_path / "port"), device="cpu")
    ttr.fit(epochs=3)
    pj = _flat(jax.tree_util.tree_map(np.asarray, jparams))
    pt = _flat(params_to_numpy(tm))
    for name in pj:
        np.testing.assert_allclose(pt[name], pj[name], rtol=0, atol=1e-5,
                                   err_msg=name)

    def losses(path):
        recs = [json.loads(l) for l in open(path / "metrics.jsonl")]
        return [r["training_loss"] for r in recs if "training_loss" in r]

    np.testing.assert_allclose(losses(tmp_path / "port"),
                               losses(tmp_path / "jax"), rtol=0, atol=1e-5)
    assert ttr.opt_count == 2 and not ttr._warmup
