"""What every cell of the benchmark shares: the manifest and the files it
names, the per-run context, host-clock statistics, CUDA-event timing, the
profiled slice and its reduction to device intervals, and the result line.

The benchmark is driven by data.  ``BENCHMARK.json`` names the cells, each
by a configuration and a traffic mix; everything else is found by name:

  * ``perfbench/configs/<config>.json``: the configuration's sizes;
  * ``perfbench/workloads/<traffic>.json``: the mix's parameters, among
    them ``generator``, the name of ``perfbench/traffic/<generator>.py``,
    and ``limits``, one per number the output check compares;
  * ``perfbench/metrics/<metric>.py``: one reader per metric, ``read(ctx)``
    returning a number, or None where the run has nothing to read.
"""
from __future__ import annotations

import importlib.util
import json
import math
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "fiode_tpu")
NAME_CHARS = 120  # a breakdown's names are cut to this many characters

__all__ = ["HERE", "ROOT", "load_manifest", "cell", "load_module",
           "subseed", "p95", "rate", "Context", "cuda_ms", "Profile",
           "profiled", "forbidden_modules", "log", "Clock", "program_model",
           "tf32", "gap"]


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def load_manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(manifest: dict, name: str, here: Path = HERE) -> dict:
    """The cell ``name``: its manifest entry, its configuration and mix
    (read from their files), and the metrics it reports by trace mode."""
    by_name = {w["name"]: w for w in manifest["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(by_name)})")
    w = by_name[name]
    conf = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    cfg = json.loads((here.parent / conf["file"]).read_text())
    mix = json.loads((here / "workloads" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in manifest["end_to_end"]
           if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    layer = [m for m in manifest["per_layer"]
             if name in m.get("workloads", [name] if m["moves"] in reported
                              else [])]
    return {"workload": w, "config": cfg, "mix": mix, "end_to_end": e2e,
            "per_layer": layer}


def load_module(kind: str, name: str, here: Path = HERE):
    """``perfbench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = here / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def subseed(seed: int, stream: int) -> int:
    """A 63-bit seed of its own for each stream of draws of a run."""
    return int(np.random.SeedSequence([int(seed), stream])
               .generate_state(1, np.uint64)[0] >> np.uint64(1))


def p95(values) -> float:
    """The 95th percentile by nearest rank over all samples."""
    v = sorted(values)
    if not v:
        raise ValueError("p95 of no samples")
    return float(v[max(0, math.ceil(0.95 * len(v)) - 1)])


def rate(work: float, seconds: float) -> float:
    """All the work of the window over all of its time."""
    if seconds <= 0:
        raise ValueError("a window of no time")
    return work / seconds


class Context:
    """What a metric's reader sees: the cell, the traffic's state after the
    window (``state.window``: its records), the profiled slice (``profile``,
    a ``Profile`` or None) and ``setup_s``."""

    def __init__(self, cell: dict, state, setup_s: float, profile=None):
        self.cell = cell
        self.config = cell["config"]
        self.mix = cell["mix"]
        self.state = state
        self.setup_s = setup_s
        self.profile = profile


def cuda_ms(fn, iters: int = 5, warmup: int = 1) -> float:
    """Mean device milliseconds of a call of ``fn``, between CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


class Profile:
    """A profiled slice: ``iterations`` of the traffic's loop, the slice's
    host span (``start_us``, ``end_us``), the device operations as (name,
    start, end) in microseconds and the host ranges as (name, start, end,
    user annotation or not)."""

    def __init__(self, iterations, start_us, end_us, device_ops, host_ops):
        self.iterations = iterations
        self.start_us, self.end_us = start_us, end_us
        self.device_ops = device_ops
        self.host_ops = host_ops

    @property
    def window_s(self) -> float:
        return (self.end_us - self.start_us) / 1e6

    def busy_intervals(self) -> list:
        """The union of the device operations' intervals, clipped to the
        slice."""
        spans = sorted((max(s, self.start_us), min(e, self.end_us))
                       for _, s, e in self.device_ops)
        out = []
        for s, e in spans:
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def kernels(self) -> list:
        """The device operations that are kernels (not copies or sets)."""
        return [op for op in self.device_ops
                if not op[0].startswith(("Memcpy", "Memset"))]

    def device_ms(self, tags) -> tuple:
        """(milliseconds, launches) of the kernels whose names hold a tag."""
        hits = [(s, e) for name, s, e in self.kernels()
                if any(t in name for t in tags)]
        return sum(e - s for s, e in hits) / 1e3, len(hits)

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps, each named by the innermost host range around its middle."""
        by_name = {}
        for name, s, e in self.device_ops:
            by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        ops = [(k[:NAME_CHARS], v) for k, v in ops]
        busy = self.busy_intervals()
        edges = [self.start_us] + [x for iv in busy for x in iv] + [self.end_us]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        named = []
        for s, e in gaps[:top]:
            mid = 0.5 * (s + e)
            around = [h for h in self.host_ops if h[1] <= mid <= h[2]]
            user = [h for h in around if h[3]]
            pick = min(user or around, key=lambda h: h[2] - h[1], default=None)
            name = pick[0][:NAME_CHARS] if pick else "(no host range)"
            named.append([name, (e - s) / 1e6])
        return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": named}


def profiled(fn) -> Profile:
    """Run ``fn()`` (which returns its iteration count and ends synchronised)
    under torch.profiler; the slice is the host range around it."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("perfbench.slice"):
            iterations = fn()
    events = prof.events()
    # a record_function range also shows on the device's timeline: it is no
    # device operation
    ranges = {e.name for e in events
              if not str(e.device_type).endswith("CUDA")
              and getattr(e, "is_user_annotation", False)}
    device_ops, host_ops, span = [], [], None
    for e in events:
        tr = e.time_range
        user = bool(getattr(e, "is_user_annotation", False))
        if str(e.device_type).endswith("CUDA"):
            if not user and e.name not in ranges:
                device_ops.append((e.name, tr.start, tr.end))
        elif e.name == "perfbench.slice":
            span = (tr.start, tr.end)
        else:
            host_ops.append((e.name, tr.start, tr.end, user))
    if span is None:
        raise RuntimeError("the profiler recorded no slice range")
    return Profile(iterations, span[0], span[1], device_ops, host_ops)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Clock:
    """Seconds since the process started, on the host's monotonic clock."""

    def __init__(self):
        self.t0 = time.perf_counter()
        try:
            ticks = float(Path("/proc/self/stat").read_text().rsplit(")", 1)[1]
                          .split()[19])
            import os
            boot_age = time.clock_gettime(time.CLOCK_BOOTTIME)
            started = ticks / os.sysconf("SC_CLK_TCK")
            self.t0 -= max(0.0, boot_age - started)
        except (OSError, ValueError, IndexError):
            pass

    def __call__(self) -> float:
        return time.perf_counter() - self.t0


def program_model(cfg: dict, device):
    """The program's classifier as the configuration states it (KWLarge
    Cayley backbone, Cayley simplex dynamics, the solver), in eval mode on
    ``device``; its weights are replaced by ``weights.load``."""
    import torch
    from fiode_tpu_torch.models.backbones import KWLargeBackbone
    from fiode_tpu_torch.models.dynamics import SimplexDynamics
    from fiode_tpu_torch.models.ivp import NeuralODEClassifier

    g = torch.Generator().manual_seed(0)
    dyn = SimplexDynamics(
        n_hidden=cfg["n_hidden"], mlp_size=cfg["mlp_size"], x_dim=cfg["x_dim"],
        activation=cfg["activation"], dropout=cfg["dropout"],
        alpha_1=cfg["alpha_1"], alpha_2=cfg["alpha_2"], sigma_1=cfg["sigma_1"],
        scale_nominal=cfg["scale_nominal"], qp_iters=cfg["qp_iters"],
        cayley=cfg["cayley"], kappa=cfg["kappa"],
        kappa_length=cfg["kappa_length"], generator=g)
    backbone = KWLargeBackbone(
        out_dim=cfg["x_dim"], act=cfg["backbone_act"], mu=cfg["mu"],
        std=cfg["std"], width=cfg["width"], in_channels=cfg["in_channels"],
        img_size=cfg["img_size"], generator=g)
    model = NeuralODEClassifier(
        backbone=backbone, dynamics=dyn, t_max=cfg["t_max"], rtol=cfg["rtol"],
        atol=cfg["atol"], max_steps=cfg["max_steps"], method=cfg["method"])
    return model.eval().to(device)


class tf32:
    """TF32 on or off for matmuls and cuDNN inside; restored after."""

    def __init__(self, on: bool):
        self.on = on

    def __enter__(self):
        import torch
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = self.on
        torch.backends.cudnn.allow_tf32 = self.on

    def __exit__(self, *exc):
        import torch
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved


def gap(a, b) -> float:
    """max |a - b|; infinite where either side is not finite."""
    d = float((a - b).abs().max())
    return d if math.isfinite(d) else math.inf
