"""The port's spans and counters (fiode_tpu_torch/utils/tracing.py) on a
tiny CPU model: off, they keep nothing and return one shared null context;
on (``enable()`` or a torch profiler), a solve and a train step leave one
root record each whose children match what the solver and the trainer
report and whose counter deltas match the solver's, the profiler shows the spans as user annotations,
and tracing changes no number."""
import contextlib
import json
import types

import numpy as np
import pytest
import torch

from fiode_tpu_torch.models.backbones import KWLargeBackbone
from fiode_tpu_torch.models.dynamics import SimplexDynamics
from fiode_tpu_torch.models.ivp import NeuralODEClassifier
from fiode_tpu_torch.train.data import Dataset
from fiode_tpu_torch.train.trainer import LyapunovTrainer, TrainConfig
from fiode_tpu_torch.utils import debug, tracing

IMG = 8
# a KWLarge forward makes one Cayley transform a layer: 4 convs, 3 linears;
# the solve's injection densifies the dynamics' 4 Cayley linears
BACKBONE_CAYLEYS, DYNAMICS_CAYLEYS = 7, 4


@pytest.fixture(autouse=True)
def traced_off():
    """Every test starts and ends with tracing off and an empty buffer."""
    tracing.disable()
    tracing.clear()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    tracing.disable()
    tracing.clear()


@pytest.fixture(scope="module")
def model():
    g = torch.Generator().manual_seed(0)
    dyn = SimplexDynamics(n_hidden=10, mlp_size=16, x_dim=10,
                          scale_nominal=True, qp_iters=8, generator=g)
    backbone = KWLargeBackbone(out_dim=10, img_size=IMG, generator=g)
    return NeuralODEClassifier(backbone, dyn, rtol=1e-3, atol=1e-3,
                               max_steps=64).eval()


@pytest.fixture(scope="module")
def images():
    return torch.rand((3, 3, IMG, IMG),
                      generator=torch.Generator().manual_seed(1))


def solve(model, x):
    with torch.no_grad():
        return model.solve(x)


def delta(before: dict, name: str) -> int:
    return tracing.counters().get(name, 0) - before.get(name, 0)


def roots(name: str) -> list:
    return [r for r in tracing.records()
            if r["name"] == name and r["parent"] is None]


def test_off_keeps_nothing_and_returns_the_shared_null_context(model,
                                                                images):
    off = tracing.span("ivp.solve")
    assert off is tracing.span("cayley")
    assert isinstance(off, contextlib.nullcontext)
    first = tracing.next_id()
    before = tracing.counters()
    sol = solve(model, images)
    assert tracing.records() == [] and tracing.next_id() == first
    # the counters are on all the same
    assert delta(before, "odeint.rejected") == sol.n_rejected
    tracing.count("x")
    assert delta(before, "x") == 1


@pytest.fixture(scope="module")
def profiled(model, images, tmp_path_factory):
    """One solve under ``debug.trace`` (a torch profiler, so tracing is on
    inside): the solution, the records, the profiler's user annotations and
    the trace's directory."""
    out = tmp_path_factory.mktemp("trace")
    tracing.disable()
    tracing.clear()
    with tracing.span("before"):
        pass
    with debug.trace(str(out)):
        sol = solve(model, images)
    (chrome,) = out.glob("*.pt.trace.json")
    events = json.loads(chrome.read_text())["traceEvents"]
    names = {e.get("name") for e in events
             if e.get("cat") == "user_annotation"}
    recs = [r for r in tracing.records() if r["name"] != "before"]
    tracing.clear()
    return sol, recs, names, out


@pytest.mark.parametrize("how", ["enable", "profiler"])
def test_a_solve_is_one_root_holding_its_steps(model, images, profiled, how):
    if how == "enable":
        tracing.enable()
        sol = solve(model, images)
        recs = tracing.records()
    else:
        sol, recs, _, _ = profiled
    (root,) = [r for r in recs if r["name"] == "ivp.solve"]
    assert root["parent"] is None
    assert all(r["root"] == root["id"] for r in recs)
    children = [r["name"] for r in recs if r["parent"] == root["id"]]
    assert sorted(children) == sorted(
        ["ivp.backbone", "ivp.inject", "odeint.first_step"]
        + ["odeint.attempt"] * sol.attempts)
    by_id = {r["id"]: r for r in recs}
    reads = [r for r in recs if r["name"] == "odeint.host_read"]
    assert len(reads) == sol.attempts
    assert {by_id[r["parent"]]["name"] for r in reads} == {"odeint.attempt"}
    cayleys = [by_id[r["parent"]]["name"] for r in recs
               if r["name"] == "cayley"]
    assert cayleys.count("ivp.backbone") == BACKBONE_CAYLEYS
    assert cayleys.count("ivp.inject") == DYNAMICS_CAYLEYS
    for r in recs:
        assert r["t0_ns"] <= r["t1_ns"] and r["device_ms"] is None


def test_a_solves_counter_deltas_match_its_solution(model, images):
    # at rtol = atol = 1e-6 the step control rejects some steps
    tight = NeuralODEClassifier(model.backbone, model.dynamics, rtol=1e-6,
                                atol=1e-6, max_steps=64).eval()
    tracing.enable()
    sol = solve(tight, images)
    assert sol.n_rejected > 0
    (root,) = roots("ivp.solve")
    assert root["counters"] == {"odeint.rejected": sol.n_rejected}
    assert [r["name"] for r in tracing.records()].count(
        "odeint.attempt") == sol.attempts


def test_cayley_solves_per_backbone_forward_and_per_solve(model, images):
    tracing.enable()
    with torch.no_grad():
        model.backbone(images)
    assert [r["name"] for r in tracing.records()] == (["cayley"]
                                                      * BACKBONE_CAYLEYS)
    tracing.clear()
    solve(model, images)
    assert [r["name"] for r in tracing.records()].count("cayley") == (
        BACKBONE_CAYLEYS + DYNAMICS_CAYLEYS)


def test_the_profiler_shows_the_spans_as_user_annotations(profiled):
    _, _, names, _ = profiled
    assert {"ivp.solve", "ivp.backbone", "ivp.inject", "cayley",
            "odeint.first_step", "odeint.attempt",
            "odeint.host_read"} <= names
    # off again once the profiler stops
    assert isinstance(tracing.span("cayley"), contextlib.nullcontext)


def test_tracing_changes_no_number(model, images):
    off = solve(model, images)
    tracing.enable()
    on = solve(model, images)
    assert torch.equal(off.ys, on.ys)
    assert (off.nfe, off.n_accepted, off.n_rejected) == (
        on.nfe, on.n_accepted, on.n_rejected)


def test_one_train_step_is_one_root_holding_the_trainers_spans(tmp_path):
    g = torch.Generator().manual_seed(0)
    dyn = SimplexDynamics(n_hidden=10, mlp_size=16, x_dim=10, dropout=0.1,
                          generator=g)
    model = NeuralODEClassifier(
        KWLargeBackbone(out_dim=10, img_size=IMG, generator=g), dyn)
    B = 4
    blank = np.zeros((B, 3, IMG, IMG), np.float32)
    labels = np.zeros(B, np.int32)
    ds = Dataset("CIFAR10", blank, labels, blank, labels, blank, labels, 10,
                 synthetic=True)
    tr = LyapunovTrainer(model, TrainConfig(batch_size=B, h_sample_size=4),
                         ds, run_dir=str(tmp_path / "run"), device="cpu")
    tr.reset_optimizer(False)
    x = torch.rand((B, 3, IMG, IMG), generator=g)
    y = torch.arange(B) % 10
    mixer = np.asarray([0.5, 0.5], np.float32)
    tracing.enable()
    tr._train_step(x, y, 0, mixer, 0.0, False)
    tr.writer.close()
    (root,) = roots("train.step")
    recs = tracing.records()
    assert all(r["root"] == root["id"] for r in recs)
    inside = {r["name"] for r in recs if r["parent"] == root["id"]}
    assert inside == {"train.augment", "train.backbone", "train.sampler",
                      "train.eval_dot", "train.lyapunov_loss",
                      "train.backward", "train.optimizer"}
    # the backbone's and the dynamics' Cayley transforms
    assert [r["name"] for r in recs].count("cayley") == (BACKBONE_CAYLEYS
                                                         + DYNAMICS_CAYLEYS)
    assert root["counters"] == {}


def test_the_buffer_drops_its_oldest_records(monkeypatch):
    monkeypatch.setattr(tracing, "MAX_RECORDS", 3)
    before = tracing.counters()
    tracing.enable()
    for name in "abcde":
        with tracing.span(name):
            pass
    assert [r["name"] for r in tracing.records()] == ["c", "d", "e"]
    assert delta(before, "tracing.dropped") == 2
    tracing.clear()
    assert tracing.records() == []


def test_nested_spans_carry_their_counter_deltas():
    tracing.enable()
    with tracing.span("outer"):
        tracing.count("x", 2)
        with tracing.span("inner"):
            tracing.count("x")
            tracing.count("y", 5)
    inner, outer = tracing.records()
    assert (inner["name"], outer["name"]) == ("inner", "outer")
    assert inner["parent"] == outer["id"] == inner["root"] == outer["root"]
    assert inner["counters"] == {"x": 1, "y": 5}
    assert outer["counters"] == {"x": 3, "y": 5}
    first = tracing.next_id()
    with tracing.span("later"):
        pass
    assert [r["name"] for r in tracing.records(since=first)] == ["later"]


def test_debug_trace_writes_the_bodys_spans(profiled):
    _, recs, _, out = profiled
    lines = [json.loads(l) for l in open(out / "spans.jsonl")]
    assert lines == recs
    assert [r["name"] for r in lines].count("ivp.solve") == 1


def test_the_device_side_copies_of_spans_are_no_device_operations(model,
                                                                  images):
    """A record_function range also shows on the device's timeline, as an
    event of its name without the user-annotation flag: the breakdowns of
    ``chip_smoke`` leaves it out of busy time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        solve(model, images)
    import chip_smoke
    ranges = chip_smoke.range_names(prof.events())
    assert {"ivp.solve", "ivp.backbone", "cayley",
            "odeint.attempt"} <= ranges
    assert not any(n.startswith("aten::") for n in ranges)
    copy, kernel = (types.SimpleNamespace(name=n, is_user_annotation=False,
                                          device_type="DeviceType.CUDA")
                    for n in ("ivp.solve", "mix_kernel"))
    host = types.SimpleNamespace(name="aten::mm", is_user_annotation=False,
                                 device_type="DeviceType.CPU")
    assert [e.name for e in (copy, kernel, host)
            if chip_smoke.is_device_op(e, ranges)] == ["mix_kernel"]
