"""The train step replayed from one CUDA graph (``train/step_graph.py``).

On the CPU: the route rule (which configurations stay eager), what a
graph's key bakes in, the CPU optimizer left as it was, and the reader of
``train_graph_replay_pct`` on hand-made records.  On the card (skipped
without one): graph-replayed steps against the eager steps of the code
before the graph (Adam not capturable, a float learning rate) from the
same state, at the benchmark's training cell, with kappa annealed and the
learning rate crossing an epoch; each step's loss its own; what drops or bypasses the
graph; the counters.  This file imports neither jax nor the JAX package;
on a GPU machine run it with

    python -m pytest --noconftest -q tests/test_torch_train_graph.py

(``--noconftest``: the suite's conftest.py sets up JAX).
"""
import copy
import dataclasses
import json
import types
from contextlib import nullcontext
from unittest import mock

import numpy as np
import pytest
import torch

from fiode_tpu_torch.models import layers
from fiode_tpu_torch.train import trainer as trainer_module
from fiode_tpu_torch.train.step_graph import graph_key, step_route
from fiode_tpu_torch.train.trainer import TrainConfig
from fiode_tpu_torch.utils import tracing
from perfbench import harness

CELL = "lyapunov-train-b128"


def _bench_cfg(**fields) -> TrainConfig:
    """The training cell's TrainConfig (as its traffic builds it)."""
    c = harness.cell(harness.load_manifest(), CELL)["config"]
    return dataclasses.replace(TrainConfig(
        opt_name=c["opt_name"], lr=c["lr"], batch_size=c["batch_size"],
        h_sample_size=c["h_sample_size"], sampler_names=tuple(c["samplers"]),
        lya_cand=c["lya_cand"], eps=c["eps"]), **fields)


# -- on the CPU ----------------------------------------------------------------

@pytest.mark.parametrize("device,fields,ode_portion,shard,want", [
    ("cuda", {}, 0.0, None, "graph"),
    ("cuda", {"opt_name": "AdamW"}, 0.0, None, "graph"),
    ("cuda", {"train_ode": True}, 0.0, None, "graph"),
    ("cpu", {}, 0.0, None, "eager"),
    ("cuda", {"adv_train": True}, 0.0, None, "eager"),
    ("cuda", {"lips_train": True}, 0.0, None, "eager"),
    ("cuda", {"sampler_names": ("UniformSimplexSampling",
                                "TrajectorySampler")}, 0.0, None, "eager"),
    ("cuda", {"train_ode": True}, 0.5, None, "eager"),
    ("cuda", {}, 0.0, (0, 2), "eager"),
    ("cuda", {"objective": "ode"}, 0.0, None, "eager"),
    ("cuda", {"objective": "classical"}, 0.0, None, "eager"),
    ("cuda", {"opt_name": "SGD"}, 0.0, None, "eager"),
])
def test_the_route_replays_only_the_plain_lyapunov_step_on_cuda(
        device, fields, ode_portion, shard, want):
    cfg = _bench_cfg(**fields)
    assert step_route(device, cfg, ode_portion=ode_portion,
                      shard=shard) == want


def _tiny_trainer(tmp_path):
    from fiode_tpu_torch.models.backbones import TinyMLPBackbone
    from fiode_tpu_torch.models.dynamics import SimplexDynamics
    from fiode_tpu_torch.models.ivp import NeuralODEClassifier
    from fiode_tpu_torch.train.data import Dataset
    g = torch.Generator().manual_seed(0)
    model = NeuralODEClassifier(
        TinyMLPBackbone(3 * 8 * 8, out_dim=10, hidden=16, generator=g),
        SimplexDynamics(n_hidden=10, mlp_size=16, x_dim=10, generator=g))
    blank = np.zeros((4, 3, 8, 8), np.float32)
    labels = np.zeros(4, np.int32)
    ds = Dataset("CIFAR10", blank, labels, blank, labels, blank, labels, 10,
                 synthetic=True)
    return trainer_module.LyapunovTrainer(
        model, _bench_cfg(batch_size=4, h_sample_size=8), ds,
        run_dir=str(tmp_path / "run"), device="cpu")


@pytest.mark.parametrize("warmup", [False, True])
def test_the_cpu_optimizer_is_the_eager_one(tmp_path, warmup):
    tr = _tiny_trainer(tmp_path)
    tr.reset_optimizer(warmup)
    for group in tr.opt.param_groups:
        assert not group["capturable"]
        assert isinstance(group["lr"], float)
    tr._train_step(torch.rand(4, 3, 8, 8), torch.arange(4), 0,
                   np.asarray([0.5, 0.5], np.float32), 0.0, False)
    assert isinstance(tr.opt.param_groups[0]["lr"], float)
    assert tr._graph is None and tr._graph_warm is None
    tr.writer.close()


def test_the_key_holds_what_a_capture_bakes_in(tmp_path):
    tr = _tiny_trainer(tmp_path)
    x, y = torch.rand(4, 3, 8, 8), torch.arange(4)
    mix = np.asarray([0.5, 0.5], np.float32)
    draws = {"augment": (torch.zeros(4, 2, dtype=torch.long),
                         torch.zeros(4, dtype=torch.bool))}
    key = graph_key(tr, x, y, mix, False, draws)
    assert graph_key(tr, x.clone(), y.clone(), mix.copy(), False,
                     copy.deepcopy(draws)) == key
    # mixers that give the same slot counts share the graph
    assert graph_key(tr, x, y, np.asarray([0.501, 0.499], np.float32), False,
                     draws) == key
    changed = [graph_key(tr, x[:2], y[:2], mix, False, draws),
               graph_key(tr, x, y, np.asarray([0.25, 0.75], np.float32),
                         False, draws),
               graph_key(tr, x, y, mix, True, draws),
               graph_key(tr, x, y, mix, False, {})]
    with mock.patch.object(layers, "fused_freq_apply", lambda *a: None):
        changed.append(graph_key(tr, x, y, mix, False, draws))
    tr.cfg.barrier_loss = True
    changed.append(graph_key(tr, x, y, mix, False, draws))
    assert all(k != key for k in changed)
    assert len(set(changed)) == len(changed)
    tr.writer.close()


def _records(replays):
    """Hand-made records of len(replays) train steps, each a root whose
    counters hold that many graph replays."""
    out = []
    for k, n in enumerate(replays):
        r = 10 * k + 1
        counters = {"train.graph_replays": n, "k3.launches": 7} if n else {}
        out += [dict(id=r + 1, name="train.optimizer", parent=r, root=r,
                     t0_ns=0, t1_ns=1000, device_ms=None, counters={}),
                dict(id=r, name="train.step", parent=None, root=r, t0_ns=0,
                     t1_ns=5000, device_ms=None, counters=counters)]
    return out


def _ctx(iterations):
    return types.SimpleNamespace(profile=harness.Profile(
        iterations, 0.0, 100.0, [("k", 0.0, 10.0)], []))


@pytest.mark.parametrize("replays,want", [((1, 1, 1, 1, 1), 100.0),
                                          ((0, 1, 1, 1), 75.0),
                                          ((0, 0), 0.0)])  # eager: no graph
def test_the_replay_share_reader(monkeypatch, replays, want):
    read = harness.load_module("metrics", "train_graph_replay_pct").read
    monkeypatch.setattr(tracing, "records", lambda since=None: _records(replays))
    assert read(_ctx(len(replays))) == want


def test_the_replay_share_reader_says_none_without_its_records(monkeypatch):
    read = harness.load_module("metrics", "train_graph_replay_pct").read
    assert read(types.SimpleNamespace(profile=None)) is None
    monkeypatch.setattr(tracing, "records", lambda since=None: _records((1, 1)))
    assert read(_ctx(3)) is None  # roots not one an iteration
    assert read(_ctx(2)) == 100.0


def test_the_metric_is_declared_for_the_training_cell_alone():
    manifest = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    (m,) = [m for m in manifest["per_layer"]
            if m["name"] == "train_graph_replay_pct"]
    assert m["workloads"] == [CELL] and m["moves"] == "train_images_per_s"
    assert m["source"] == "program_counter" and m["unit"] == "%"


# -- on the card ---------------------------------------------------------------

@pytest.fixture
def cuda():
    """The card, or a skip where there is none (decided here, not at
    import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: this test runs on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


STEPS = 6
STEPS_PER_EPOCH = 3  # the learning rate changes between steps 2 and 3
KAPPA_LENGTH = 4     # kappa climbs over steps 0-4


def _workload() -> dict:
    return json.loads((harness.HERE / "workloads" / "lyapunov-b128.json")
                      .read_text())


def _limits() -> dict:
    return _workload()["limits"]


def _trainer(seed, device):
    """The benchmark's training cell at full size, before its first step,
    with kappa annealed and a short epoch."""
    gen = harness.load_module("traffic", "train_step")
    cell = harness.cell(harness.load_manifest(), CELL)
    cell["mix"] = dict(cell["mix"], checked_steps=0)
    st = gen.setup(cell, seed, device)
    tr = st.trainer
    tr.model.dynamics.kappa_length = KAPPA_LENGTH
    tr.steps_per_epoch = STEPS_PER_EPOCH
    tr.cfg.max_epochs = 4
    tr.opt_count = 0
    return gen, st, tr


def _state(tr) -> dict:
    """Every parameter, gradient and Adam moment, copied."""
    out = {}
    for name, p in tr.model.named_parameters():
        out["p " + name] = p.detach().clone()
        if p.grad is not None:
            out["g " + name] = p.grad.clone()
        for k in ("exp_avg", "exp_avg_sq"):
            if k in tr.opt.state.get(p, {}):
                out[f"{k} {name}"] = tr.opt.state[p][k].clone()
    return out


def _kind(before: dict) -> str:
    c = tracing.counters()
    if c.get("train.graph_captures", 0) > before.get("train.graph_captures", 0):
        return "capture"
    if c.get("train.graph_replays", 0) > before.get("train.graph_replays", 0):
        return "replay"
    return "eager"


def _run(gen, st, tr, handed: bool):
    """STEPS steps from the trainer's state, a seed set before step 3 and
    the generator's state after step 3 set again before step 5; per step:
    its kind, loss read at once and the state after it, and the returned
    losses."""
    st.g_draw = torch.Generator(st.device).manual_seed(st.seed % 2 ** 31)
    kinds, at_once, states, losses = [], [], [], []
    saved = None
    for i in range(STEPS):
        if i == 3:
            tr.gen.manual_seed(st.seed % 2 ** 31 + 7)
        if i == 5:
            tr.gen.set_state(saved)
        draws = gen._draws(st) if handed else None
        c = tracing.counters()
        loss, _ = tr._train_step(st.x[i % len(st.x)], st.y[i % len(st.y)], i,
                                 st.mixer, 0.0, st.scale_nominal, draws=draws)
        torch.cuda.synchronize()
        kinds.append(_kind(c))
        at_once.append(loss.item())
        losses.append(loss)
        states.append(_state(tr))
        if i == 3:
            saved = tr.gen.get_state()
    return kinds, at_once, states, losses


def _gap(got, want, median) -> float:
    return float((got - want).norm()) / max(float(want.norm()), median, 1e-30)


def _changes(states, start) -> list:
    """Each step's state with every parameter replaced by its change from
    ``start``."""
    return [{k: v - start[k[2:]] if k.startswith("p ") else v
             for k, v in state.items()} for state in states]


def _held_to(graph, eager, loss_g, loss_e, loss_steps, grad_steps,
             change_steps):
    """Each leaf within the training cell's limits: the losses of
    ``loss_steps`` (loss_gap), every gradient and Adam moment after
    ``grad_steps`` (grad_gap) and every parameter's change after
    ``change_steps`` (change_gap)."""
    lim = _limits()
    for i in loss_steps:
        assert abs(loss_g[i] - loss_e[i]) <= lim["loss_gap"] * abs(loss_e[i]), i
    for kinds, limit, steps in (
            (("g ", "exp_avg ", "exp_avg_sq "), lim["grad_gap"], grad_steps),
            (("p ",), lim["change_gap"], change_steps)):
        for i in steps:
            norms = {k: float(v.norm()) for k, v in eager[i].items()}
            for kind in kinds:
                names = [k for k in eager[i] if k.startswith(kind)]
                assert names and set(names) <= set(graph[i]), (i, kind)
                median = float(np.median([norms[k] for k in names]))
                for k in names:
                    assert _gap(graph[i][k], eager[i][k], median) <= limit, (i, k)


@pytest.mark.parametrize("handed", [True, False], ids=["draws", "generator"])
@pytest.mark.parametrize("seed", [2 ** 31 + 5, 2 ** 33 + 17, 977])
def test_replayed_steps_equal_eager_steps(cuda, seed, handed):
    """The graph route's steps from one state against two eager runs from
    it.  (a) The same body and optimizer, eager (the route off after the
    optimizer's making: Adam capturable, a device learning rate): every
    step's loss, gradient, Adam moment and parameter change, each leaf
    within the training cell's limits, so the capture adds nothing.
    (b) The eager step of the code before the graph (the route off from
    the optimizer's making on: Adam not capturable, a float learning
    rate), held as the training cell holds the program to its reference:
    the first step's loss, the first gradient and Adam moments, and every
    parameter's change over the cell's checked steps.  The capturable
    Adam takes its bias correction in float32 (1 - 0.999 reads 1.3e-5
    low, so the first update is 6.5e-6 smaller), and Adam turns that
    round-off on a gradient near zero into a move of up to 2 lr, which
    the later steps' losses and gradients carry."""
    gen, st, tr = _trainer(seed, cuda)
    start = copy.deepcopy(tr.model.state_dict())
    p0 = {k: p.detach().clone() for k, p in tr.model.named_parameters()}
    gen_state = tr.gen.get_state()
    kinds, at_once, graph, losses = _run(gen, st, tr, handed)
    assert kinds == ["eager", "capture"] + ["replay"] * (STEPS - 2)
    # each step's returned loss is its own, after the later steps too
    assert [float(v) for v in losses] == at_once
    assert len(set(at_once)) == STEPS
    eager_route = mock.patch.object(trainer_module, "step_route",
                                    lambda *a, **k: "eager")
    runs = {}
    for side in ("same optimizer", "before the graph"):
        tr.model.load_state_dict(start)
        tr.gen.set_state(gen_state)
        with eager_route if side == "before the graph" else nullcontext():
            tr.reset_optimizer(False)
        tr.opt_count = 0
        for group in tr.opt.param_groups:
            capturable = side == "same optimizer"
            assert group["capturable"] == capturable
            assert isinstance(group["lr"], torch.Tensor) == capturable
        with eager_route:
            kinds_e, losses_e, states, _ = _run(gen, st, tr, handed)
        assert kinds_e == ["eager"] * STEPS
        runs[side] = (losses_e, _changes(states, p0))
    graph = _changes(graph, p0)
    every = range(STEPS)
    _held_to(graph, runs["same optimizer"][1], at_once,
             runs["same optimizer"][0], every, every, every)
    checked = range(_workload()["checked_steps"])
    _held_to(graph, runs["before the graph"][1], at_once,
             runs["before the graph"][0], [0], [0], checked)
    tr.writer.close()


def test_what_drops_or_bypasses_the_graph(cuda):
    """The first step of a key runs eager and the next captures; a fresh
    optimizer, a loaded optimizer state, a mixer that moves the slot
    counts and the plain conv apply each drop or bypass the graph; the
    counters count captures and replays, and K3's launches grow by 7 a
    replayed step."""
    from fiode_tpu_torch.ops.cayley import apply_freq_matrices

    def plain_freq_apply(x, Qr, Qi):
        return apply_freq_matrices(x, torch.complex(Qr, Qi), impl="dft")

    gen, st, tr = _trainer(2 ** 32 + 99, cuda)
    x, y = st.x[0], st.y[0]
    mix = st.mixer

    def step(mixer=mix):
        c = tracing.counters()
        tr._train_step(x, y, 0, mixer, 0.0, st.scale_nominal)
        torch.cuda.synchronize()
        now = tracing.counters()
        return _kind(c), {k: now.get(k, 0) - c.get(k, 0)
                          for k in ("k3.launches", "train.graph_replays",
                                    "train.graph_captures")}

    assert [step()[0] for _ in range(3)] == ["eager", "capture", "replay"]
    kind, delta = step()
    assert kind == "replay" and delta == {
        "k3.launches": 7, "train.graph_replays": 1, "train.graph_captures": 0}
    tr.reset_optimizer(False)
    assert [step()[0] for _ in range(3)] == ["eager", "capture", "replay"]
    tr.opt.load_state_dict(copy.deepcopy(tr.opt.state_dict()))
    assert [step()[0] for _ in range(2)] == ["capture", "replay"]
    other = np.asarray([0.25, 0.75], np.float32)
    assert [step(other)[0] for _ in range(3)] == ["eager", "capture", "replay"]
    assert step()[0] == "eager"
    with mock.patch.object(layers, "fused_freq_apply", plain_freq_apply):
        kind, delta = step()
    assert kind == "eager" and delta["k3.launches"] == 0
    kind, delta = step()
    assert kind == "eager" and delta["k3.launches"] == 7
    assert [step()[0] for _ in range(2)] == ["capture", "replay"]
    tr.writer.close()
