"""Closed loop, one caller: ``NeuralODEClassifier.solve`` back to back, each
on a batch of B images, each timed from its issue until its endpoints are
synchronised (a served prediction waits for its result).

Inputs: a pool of ``pool`` batches of images uniform in [0, 1), drawn from
the seed on the device; the i-th solve takes batch i mod pool plus
float32(i) ``perturb`` (as ``fiode_tpu_torch/bench.py`` perturbs them).

Output check: ``check_solves`` of the window's solves, drawn from the seed,
solved again by the plain reference (``perfbench/reference``: the backbone,
the RHS and dopri5 with batch-global step control) on the same inputs and
raw weights, in float32 with TF32 off.  Compared: the largest gap of an
endpoint (``endpoint_gap``).  The NFE of each side goes to stderr: it is
not compared, since a step whose error ratio lies within round-off of 1
may be taken by one side and rejected by the other.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from perfbench import harness, weights
from perfbench.reference import dopri5, model as ref

__all__ = ["setup", "window", "traced_slice", "release", "check", "answers"]


class State:
    pass


def setup(cell: dict, seed: int, device) -> State:
    cfg, mix = cell["config"], cell["mix"]
    st = State()
    st.cfg, st.mix, st.device, st.seed = cfg, mix, torch.device(device), seed
    st.model = harness.program_model(cfg, device)
    shapes = {k: tuple(p.shape) for k, p in st.model.named_parameters()}
    st.params = weights.draw(shapes, harness.subseed(seed, 0), device)
    weights.load(st.model, st.params)
    g = torch.Generator(device).manual_seed(harness.subseed(seed, 1))
    B, c, n = mix["batch"], cfg["in_channels"], cfg["img_size"]
    st.pool = torch.rand((mix["pool"], B, c, n, n), generator=g, device=device)
    st.solve = st.model.solve
    st.next = 0
    _one(st, st.pool.shape[0])  # warm-up: every shape of the window
    return st


def inputs(st: State, i: int) -> torch.Tensor:
    shift = float(np.float32(i) * np.float32(st.mix["perturb"]))
    return st.pool[i % st.pool.shape[0]] + shift


def _sync(st):
    if st.device.type == "cuda":
        torch.cuda.synchronize(st.device)


def _one(st: State, i: int):
    with torch.no_grad():
        sol = st.solve(inputs(st, i))
    _sync(st)
    return sol


def window(st: State, seconds: float) -> None:
    """Solves back to back until ``seconds`` have passed since the first
    was issued; the window ends when the last one finishes."""
    ms, nfe, attempts, ends = [], [], [], []
    _sync(st)
    t_start = time.perf_counter()
    stop, t1, i = t_start + seconds, t_start, 0
    while t1 < stop:
        t0 = time.perf_counter()
        sol = _one(st, i)
        t1 = time.perf_counter()
        ms.append(1e3 * (t1 - t0))
        nfe.append(sol.nfe)
        attempts.append(sol.attempts)
        ends.append(sol.ys[-1])
        i += 1
    st.next = i
    quarters = np.array_split(np.asarray(ms), 4)
    harness.log("solves a second by quarter of the window: " + ", ".join(
        f"{1e3 * len(q) / max(float(q.sum()), 1e-9):.2f}" for q in quarters))
    st.window = {"seconds": t1 - t_start, "ms": ms, "nfe": nfe,
                 "attempts": attempts, "ends": ends,
                 "attempted": i, "items": i * st.mix["batch"]}


def traced_slice(st: State) -> int:
    """``profile_iterations`` more solves of the same loop."""
    k = st.mix["profile_iterations"]
    for j in range(k):
        _one(st, st.next + j)
    return k


def failures(st: State) -> int:
    bad = 0
    for a, y in zip(st.window["attempts"], st.window["ends"]):
        bad += a >= st.cfg["max_steps"] or not bool(torch.isfinite(y).all())
    return bad


def release(st: State) -> None:
    """Keep the sampled solves' endpoints; free the program's state."""
    w = st.window
    rng = np.random.default_rng(harness.subseed(st.seed, 9))
    k = min(st.mix["check_solves"], len(w["ends"]))
    st.sampled = sorted(rng.choice(len(w["ends"]), k, replace=False).tolist())
    st.answers = {i: (w["ends"][i], w["nfe"][i]) for i in st.sampled}
    w["ends"] = None
    st.model = st.solve = None
    if st.device.type == "cuda":
        torch.cuda.empty_cache()


def reference(st: State, i: int):
    """(endpoints, NFE) of solve i by the plain reference."""
    cfg, P = st.cfg, st.params
    with torch.no_grad():
        feats = ref.backbone(P, inputs(st, i), cfg)
        dense = ref.dense_dynamics(P)
        xc = ref.injection(feats, dense)
        h0 = torch.full((feats.shape[0], cfg["n_hidden"]), 1.0 / cfg["n_hidden"],
                        device=feats.device)
        y, nfe, _ = dopri5.solve(
            lambda t, h: ref.rhs(h, xc, dense, cfg, cfg["scale_nominal"]),
            h0, cfg["t_max"], cfg["rtol"], cfg["atol"], cfg["max_steps"])
    return y, nfe


def answers(st: State, control: str | None = None) -> dict:
    """The answers judged: the program's, or with ``control`` set, the
    reference's computed the way the control says (``"tf32"``)."""
    if control is None:
        return st.answers
    if control != "tf32":
        raise ValueError(f"no control {control!r} for the solve")
    with harness.tf32(True):
        return {i: reference(st, i) for i in st.sampled}


def check(st: State, control: str | None = None) -> dict:
    got = answers(st, control)
    gap = 0.0
    with harness.tf32(False):
        for i in st.sampled:
            y_ref, nfe_ref = reference(st, i)
            y, nfe = got[i]
            gap = max(gap, harness.gap(y, y_ref))
            harness.log(f"solve {i}: NFE {nfe}, reference {nfe_ref}")
    return {"endpoint_gap": gap}

