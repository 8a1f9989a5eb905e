"""The readers of the program's spans and counters (``perfbench/spans.py``
and the ten metrics that use it) on hand-made records and a hand-made
profile: each value, and None where the records are missing or not one
root an iteration; a tiny cell traced on the CPU; and, on the card, the
launch counters held to the trace's kernels and the readers of the
trace's runtime calls to a second trace of one B 32,768 solve and one
training step."""
import collections
import types

import pytest
import torch

from perfbench import harness, run, spans
from perfbench.conftest import tiny_cell

METRICS = ("solve_backbone_device_ms", "solve_idle_ms.backbone",
           "solve_idle_ms.step_control", "host_reads_per_solve",
           "device_allocs_per_solve", "rejected_steps_per_solve",
           "crown_device_ms_per_chunk", "qp_device_ms_per_chunk",
           "host_reads_per_step", "optimizer_host_ms")


def read(name, ctx):
    return harness.load_module("metrics", name).read(ctx)


def rec(rid, name, parent=None, root=None, device_ms=None, counters=None,
        t=(0, 0), **extra):
    return dict({"id": rid, "name": name, "parent": parent,
                 "root": rid if root is None else root, "t0_ns": t[0],
                 "t1_ns": t[1], "device_ms": device_ms,
                 "counters": counters or {}}, **extra)


def two_solves():
    out = []
    for k, (rej, bb) in enumerate(((1, 60.0), (0, 62.0))):
        r = 10 * k + 1
        out += [rec(r + 1, "ivp.backbone", r, r, bb),
                rec(r + 2, "odeint.attempt", r, r, 1.0),
                rec(r, "ivp.solve", device_ms=90.0,
                    counters={"odeint.rejected": rej} if rej else {})]
    return out


def two_steps():
    out = []
    for k, ms in enumerate((1.2, 1.4)):
        r = 10 * k + 1
        out += [rec(r + 1, "train.optimizer", r, r,
                    t=(0, int(ms * 1e6))),
                rec(r, "train.step")]
    return out


def one_block():
    out = [rec(2 + 2 * k + j, name, 1, 1, ms)
           for k in range(4)
           for j, (name, ms) in enumerate((("certify.crown", 36.0 + k),
                                           ("certify.qp", 13.0)))]
    return out + [rec(1, "certify.crown_block")]


def calls(root, counts):
    """Host ranges: one ``root`` range a count, 0-50 and 50-100, and in
    each the given number of waits of each kind and cudaMalloc calls, with
    some just outside every range."""
    out = [("cudaStreamSynchronize", 100.5, 100.6, False)]
    for k, (waits, lu_waits, mallocs) in enumerate(counts):
        a = 50.0 * k
        out.append((root, a, a + 49.0, True))
        out += [("cudaStreamSynchronize", a + 1 + i / 10, a + 1.05 + i / 10,
                 False) for i in range(waits)]
        out += [("cudaDeviceSynchronize", a + 20 + i, a + 20.5 + i, False)
                for i in range(lu_waits)]
        out += [("cudaMalloc", a + 30 + i, a + 30.5 + i, False)
                for i in range(mallocs)]
        out += [("cudaMemcpyAsync", a + 40, a + 40.1, False),
                ("cudaFree", a + 41, a + 41.1, False),
                ("cudaStreamSynchronize", a + 49.5, a + 49.6, False)]
    return out


def profile(iterations, host_ops, device_ops=(("k", 0.0, 10.0),)):
    return harness.Profile(iterations, 0.0, 100.0, list(device_ops),
                           list(host_ops))


@pytest.fixture
def records(monkeypatch):
    """Hand the readers the given records in place of the program's."""
    from fiode_tpu_torch.utils import tracing

    def use(recs):
        monkeypatch.setattr(tracing, "records", lambda since=None: recs)
    return use


def ctx(iterations=2, host_ops=(), device_ops=(("k", 0.0, 10.0),)):
    return types.SimpleNamespace(
        profile=profile(iterations, host_ops, device_ops))


def test_the_solve_readers(records):
    records(two_solves())
    c = ctx(host_ops=calls("ivp.solve", ((38, 3, 3), (40, 3, 1))))
    assert read("solve_backbone_device_ms", c) == 61.0
    assert read("host_reads_per_solve", c) == (41 + 43) / 2
    assert read("device_allocs_per_solve", c) == 2.0
    assert read("rejected_steps_per_solve", c) == 0.5


def test_the_certify_and_train_readers(records):
    records(one_block())
    assert read("crown_device_ms_per_chunk", ctx(1)) == 37.5
    assert read("qp_device_ms_per_chunk", ctx(1)) == 13.0
    records(two_steps())
    c = ctx(host_ops=calls("train.step", ((12, 3, 0), (11, 3, 0))))
    assert read("host_reads_per_step", c) == (15 + 14) / 2
    assert read("optimizer_host_ms", c) == pytest.approx(1.3)


def test_the_idle_readers_attribute_each_gap_by_its_midpoint():
    # busy 0-10, 30-40, 60-70, 95-100: gaps 10-30, 40-60, 70-95
    busy = [("k", 0.0, 10.0), ("k", 30.0, 40.0), ("k", 60.0, 70.0),
            ("k", 95.0, 100.0)]
    host = [("ivp.solve", 0.0, 50.0, True), ("ivp.solve", 50.0, 100.0, True),
            ("ivp.backbone", 5.0, 35.0, True),
            ("cayley", 15.0, 25.0, True),      # inside the backbone
            ("ivp.backbone", 52.0, 55.0, True),
            ("odeint.attempt", 65.0, 99.0, True),
            ("odeint.host_read", 80.0, 90.0, True),
            ("aten::add", 41.0, 59.0, False)]
    c = ctx(2, host, busy)
    # 10-30 (mid 20) is the backbone's; 40-60 (mid 50) nobody's program span
    assert read("solve_idle_ms.backbone", c) == pytest.approx(20e-3 / 2)
    # 70-95 (mid 82.5) lies in odeint.attempt and its host read
    assert read("solve_idle_ms.step_control", c) == pytest.approx(25e-3 / 2)


@pytest.mark.parametrize("name", METRICS)
def test_every_reader_says_none_without_its_records(records, name):
    assert read(name, types.SimpleNamespace(profile=None)) is None
    records([])
    assert read(name, ctx()) is None
    # roots not one an iteration
    records(two_solves() + two_steps() + one_block())
    assert read(name, ctx(iterations=3)) is None


def test_the_device_readers_say_none_on_the_cpu(records):
    records([dict(r, device_ms=None) for r in two_solves()])
    c = ctx(host_ops=calls("ivp.solve", ((0, 0, 0), (0, 0, 0))),
            device_ops=())
    assert read("solve_backbone_device_ms", c) is None
    assert read("device_allocs_per_solve", c) is None
    assert read("host_reads_per_solve", c) is None
    assert read("rejected_steps_per_solve", c) == 0.5


def test_a_program_without_tracing_gives_none(records, monkeypatch):
    """The parent of the change that added the tracing module: its traced
    runs read these metrics as None, and no reader raises."""
    import sys

    import fiode_tpu_torch.utils
    records(two_solves() + two_steps() + one_block())
    assert read("rejected_steps_per_solve", ctx()) is not None
    monkeypatch.delattr(fiode_tpu_torch.utils, "tracing")
    monkeypatch.setitem(sys.modules, "fiode_tpu_torch.utils.tracing", None)
    for name in METRICS:
        assert read(name, ctx()) is None


def test_a_tiny_solve_cell_traced_on_the_cpu_reads_its_counters():
    res = run.run(tiny_cell("ode-solve-b32768"), 2 ** 31 + 11, 0.2, True,
                  "cpu", harness.Clock())
    m = {k: v["value"] for k, v in res["metrics"].items()}
    # no device: neither device intervals nor device operations
    for name in ("solve_backbone_device_ms", "solve_idle_ms.backbone",
                 "solve_idle_ms.step_control", "device_allocs_per_solve",
                 "host_reads_per_solve"):
        assert name not in m
    assert m["rejected_steps_per_solve"] >= 0




# -- on the card ---------------------------------------------------------------

# the program's spans and the library call whose waits and allocations are
# its own: a call is put down to the innermost of these around it
SITES = ("ivp.backbone", "ivp.inject", "odeint.first_step", "odeint.host_read",
         "odeint.attempt", "cayley", "train.augment", "train.backbone",
         "train.sampler", "train.eval_dot", "train.lyapunov_loss",
         "train.backward", "train.optimizer", "aten::linalg_lu_factor_ex")


def _site(e, root) -> str:
    p = e.cpu_parent
    while p is not None:
        if p.name in SITES or p.name == root:
            return p.name
        p = p.cpu_parent
    return "(" + root + ", another thread)"


def _tree(fn, root):
    """Run ``fn`` once under the profiler: the launch counters' deltas, the
    trace's kernels by name, and its waits and cudaMalloc calls inside the
    root's host range by the profiler's own tree, each put down to its
    site."""
    from torch.profiler import ProfilerActivity, profile

    from fiode_tpu_torch.utils import tracing
    torch.cuda.synchronize()
    c0 = tracing.counters()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    c1 = tracing.counters()
    events = prof.events()
    (rng,) = [e.time_range for e in events if e.name == root
              and not str(e.device_type).endswith("CUDA")]
    waits, mallocs = collections.Counter(), collections.Counter()
    kernels = collections.Counter()
    for e in events:
        if str(e.device_type).endswith("CUDA"):
            for tag in ("fused_rhs_kernel", "fused_rhs_backward",
                        "mix_kernel"):
                kernels[tag] += tag in e.name
        elif rng.start <= e.time_range.start <= rng.end:
            if e.name in spans.WAITS:
                waits[f"{_site(e, root)} {e.name}"] += 1
            elif e.name == "cudaMalloc":
                mallocs[_site(e, root)] += 1
    delta = {k: v - c0.get(k, 0) for k, v in c1.items() if v != c0.get(k, 0)}
    return delta, kernels, waits, mallocs


@pytest.mark.chip
def test_the_counters_and_readers_agree_with_the_trace_on_the_card(cuda):
    """One B 32,768 solve and one training step in steady state: K1's and
    K3's launch counters against the trace's kernels (K3 by its mix
    kernel, one of its three a launch), and the readers of the waits and
    allocations on the harness's profile against a second profile of the
    same call, where each wait and allocation is put down to its site by
    the profiler's tree and printed."""
    for cell, traffic, root, readers in (
            ("ode-solve-b32768", "solve", "ivp.solve",
             ("host_reads_per_solve", "device_allocs_per_solve")),
            ("lyapunov-train-b128", "train_step", "train.step",
             ("host_reads_per_step",))):
        gen = harness.load_module("traffic", traffic)
        c = harness.cell(harness.load_manifest(), cell)
        st = gen.setup(c, 2 ** 31 + 12345, cuda)
        if traffic == "solve":
            def fn():
                gen._one(st, 7)
                return 1
        else:
            draws = gen._draws(st)

            def fn():
                gen._step(st, st.next, draws)
                return 1
        fn()
        profile = harness.profiled(fn)
        got = {name: read(name, types.SimpleNamespace(profile=profile))
               for name in readers}
        delta, kernels, waits, mallocs = _tree(fn, root)
        print(f"{cell}: counters {delta}; kernels {dict(kernels)}; readers "
              f"{got}; waits by site {dict(waits)}; cudaMalloc by site "
              f"{dict(mallocs)}")
        assert delta.get("k1.launches", 0) == kernels["fused_rhs_kernel"]
        assert delta.get("k3.launches", 0) == kernels["mix_kernel"]
        assert got[readers[0]] == sum(waits.values())
        if len(readers) > 1:
            assert got[readers[1]] == sum(mallocs.values())
        st = None
        torch.cuda.empty_cache()
