"""The certifier's CROWN sweep: ``Certifier.crown_block`` over
``Certifier.iter_blocks`` of the real decision-boundary grid, for
``images`` images at once (the certify runner's ``--image-batch``), blocks
of ``superchunk`` chunks of ``chunk`` cells, one host read of the images'
worst values a block.  The window is the fewest whole sweeps of the grid,
each from its first block to its padded last, that last at least the
window's seconds, so that its rate is the grid's own average whatever the
program's speed.

Inputs: the trained checkpoint that the configuration names
(``checkpoint``: its path in the checkout and its sha256 digest; a file
with another digest stops the run before its window), for the program and
the reference alike; the images ``first`` .. ``first + images - 1`` of the
synthetic test set that the mix names (``test_set``) and their labels, the
certify runner's ``--image-batch`` on that set, in an order drawn from the
seed.  Every seed sweeps the same images against the same labels, so that
the work is the same and only its order moves: each image's cost follows
which of the dynamics' ReLU units its features leave on.  The feature
biases x U^T + bU come from the program's backbone, as
``Certifier.certify`` takes them.  The clean check is left out: every
image is swept against its label.

Output check: ``check_blocks`` of the window's blocks, drawn from the seed,
bounded again by the plain reference (features, Cayley weights, CROWN, the
interval QP and the worst Vdot), in float32 with TF32 off.  Compared: the
feature biases (``bias_gap``, over their largest magnitude), each image's
worst value over each sampled block (``worst_gap``, over the largest
magnitude of the block's worst values; infinite where the program's grid
is not the whole decision-boundary grid in its order, since its blocks
then sweep other cells than the reference's).
"""
from __future__ import annotations

import functools
import itertools
import time

import numpy as np
import torch

from perfbench import data, harness, weights
from perfbench.reference import crown as ref_crown, model as ref

__all__ = ["setup", "window", "traced_slice", "release", "check", "answers"]


class State:
    pass


def setup(cell: dict, seed: int, device) -> State:
    from fiode_tpu_torch.verify.certify import (Certifier, float32_matmuls,
                                                label_perms)
    cfg, mix = cell["config"], cell["mix"]
    st = State()
    st.cfg, st.mix, st.device, st.seed = cfg, mix, torch.device(device), seed
    st.f32 = float32_matmuls
    model = harness.program_model(cfg, device)
    shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
    ck = cfg["checkpoint"]
    st.params = weights.checkpoint(harness.ROOT / ck["path"], ck["sha256"],
                                   shapes, device)
    weights.load(model, st.params)
    ts, I = mix["test_set"], mix["images"]
    xs, ys = data.synthetic_test_set(ts["seed"], ts["size"], cfg["n_hidden"],
                                     cfg["in_channels"], cfg["img_size"],
                                     ts["noise"])
    rows = slice(ts["first"], ts["first"] + I)
    order = torch.randperm(I, generator=torch.Generator().manual_seed(
        harness.subseed(seed, 1)))
    st.images = torch.from_numpy(xs[rows][order.numpy()]).to(device)
    st.labels = torch.from_numpy(ys[rows][order.numpy()]).long().to(device)
    st.cert = Certifier(model, T=cfg["T"], eps_input=cfg["eps"],
                        chunk=cfg["chunk"])
    with torch.no_grad(), float32_matmuls():
        feats = model.features(st.images)
        st.x_biases = feats @ st.cert.U.T + st.cert.bU
    st.perms = label_perms(st.labels, cfg["n_hidden"])
    st.chunk_ms = functools.partial(chunk_ms, st)
    _block(st, next(_sweep(st))[1])  # warm-up: the window's shapes
    return st


def _sweep(st: State):
    """(index, block) over the whole grid, from its first block."""
    return enumerate(st.cert.iter_blocks(st.cfg["superchunk"]))


def _block(st: State, block):
    """One block: its valid cells and each image's worst value over it
    (read to the host, as ``Certifier.certify`` reads it)."""
    etas, valids, n_valid = block
    start = torch.full((st.labels.shape[0],), float("-inf"), device=st.device)
    with torch.no_grad(), st.f32():
        worst = st.cert.crown_block(st.x_biases, st.labels, st.perms, etas,
                                    valids, start)
        w = worst.cpu()
    return n_valid, w


def chunk_ms(st: State, part: str, iters: int = 3):
    """Device ms of the CROWN bounds (``part="crown"``) or of the interval
    QP on them (``"qp"``) on the first chunk of the grid, for every image."""
    from fiode_tpu_torch.verify.crown import crown_mlp_bounds
    from fiode_tpu_torch.verify.ibp_qp import ibp_cbf_qp
    if st.device.type != "cuda":
        return None
    cert, I = st.cert, st.labels.shape[0]
    etas, _, _ = next(iter(cert.iter_blocks(st.cfg["superchunk"])))
    C, n = etas.shape[1], etas.shape[2]
    eta = cert.swap_columns(etas[0], st.perms).reshape(I * C, n)
    x_rows = st.x_biases[:, None, :].expand(I, C, -1).reshape(I * C, -1)

    def bounds():
        return crown_mlp_bounds(cert.Ws, cert.bs, eta, cert.eps, x_rows)

    with torch.no_grad(), st.f32():
        if part == "crown":
            return harness.cuda_ms(bounds, iters)
        lb, ub = bounds()
        return harness.cuda_ms(lambda: ibp_cbf_qp(
            eta, cert.eps, lb, ub, cert.alpha_1, cert.sigma_1, cert.alpha_2),
            iters)


def window(st: State, seconds: float) -> None:
    """Whole sweeps of the grid until the window has lasted ``seconds``."""
    ms, done, worsts = [], [], []
    if st.device.type == "cuda":
        torch.cuda.synchronize(st.device)
    t_start = time.perf_counter()
    t1, cells, sweeps = t_start, 0, 0
    while sweeps == 0 or t1 - t_start < seconds:
        for b, block in _sweep(st):
            t0 = time.perf_counter()
            n_valid, w = _block(st, block)
            t1 = time.perf_counter()
            ms.append(1e3 * (t1 - t0))
            done.append(b)
            worsts.append(w)
            cells += n_valid * st.labels.shape[0]
        sweeps += 1
    st.window = {"seconds": t1 - t_start, "ms": ms, "blocks": done,
                 "worsts": worsts, "attempted": len(done), "items": cells,
                 "sweeps": sweeps}


def traced_slice(st: State) -> int:
    """The grid's first ``profile_blocks`` blocks."""
    k = st.mix["profile_blocks"]
    for _, block in itertools.islice(_sweep(st), k):
        _block(st, block)
    return k


def failures(st: State) -> int:
    return sum(not bool(torch.isfinite(w).all()) for w in st.window["worsts"])


def release(st: State) -> None:
    """Keep the sampled blocks' answers and cells; free the program's
    state."""
    w = st.window
    rng = np.random.default_rng(harness.subseed(st.seed, 9))
    k = min(st.mix["check_blocks"], len(w["blocks"]))
    st.sampled = sorted(rng.choice(len(w["blocks"]), k, replace=False).tolist())
    C, K = st.cfg["chunk"], st.cfg["superchunk"]
    grid = st.cert.grid
    st.grid_faults = ref_crown.grid_faults(grid, st.cfg["T"], st.device)
    st.cells = {j: grid[b * C * K:(b + 1) * C * K]
                for j, b in ((j, w["blocks"][j]) for j in st.sampled)}
    st.answers = {"x_biases": st.x_biases,
                  "worsts": {j: w["worsts"][j] for j in st.sampled}}
    st.cert = st.x_biases = None
    if st.device.type == "cuda":
        torch.cuda.empty_cache()


def _etas(st, rows):
    """A block's cells as (K, C, n) with its validity mask, padded as
    ``Certifier.iter_blocks`` pads the last block."""
    C, K, n = st.cfg["chunk"], st.cfg["superchunk"], st.cfg["n_hidden"]
    etas = torch.zeros((K * C, n), device=st.device)
    etas[:len(rows)] = torch.from_numpy(np.ascontiguousarray(rows)).to(st.device)
    valids = torch.arange(K * C, device=st.device) < len(rows)
    return etas.view(K, C, n), valids.view(K, C)


def reference(st: State, j=None):
    """The reference's feature biases, or its worst values over sampled
    block j."""
    cfg, P = st.cfg, st.params
    with torch.no_grad():
        dense = ref.dense_dynamics(P)
        U, bU = dense["U_x"]
        x_biases = ref.backbone(P, st.images, cfg) @ U.T + bU
        if j is None:
            return x_biases
        Ws = [dense[k][0] for k in ("hidden_to_mlp", "mlp_to_mlp", "mlp_to_hidden")]
        bs = [dense[k][1] for k in ("hidden_to_mlp", "mlp_to_mlp", "mlp_to_hidden")]
        etas, valids = _etas(st, st.cells[j])
        return ref_crown.block_worst(Ws, bs, x_biases, st.labels, etas,
                                     valids, 1.0 / cfg["T"],
                                     ref_crown.kappa(cfg), cfg)


def answers(st: State, control: str | None = None) -> dict:
    if control is None:
        return st.answers
    if control != "tf32":
        raise ValueError(f"no control {control!r} for the CROWN sweep")
    with harness.tf32(True):
        return {"x_biases": reference(st),
                "worsts": {j: reference(st, j).cpu() for j in st.sampled}}


def check(st: State, control: str | None = None) -> dict:
    got = answers(st, control)
    with harness.tf32(False):
        xb = reference(st)
        bias_gap = harness.gap(got["x_biases"], xb) / float(xb.abs().max())
        worst_gap = 0.0
        for j in st.sampled:
            w_ref = reference(st, j).cpu()
            scale = max(float(w_ref.abs().max()), 1e-30)
            worst_gap = max(worst_gap, harness.gap(got["worsts"][j], w_ref) / scale)
    if st.grid_faults:
        harness.log(f"the program's grid is {st.grid_faults} rows off the "
                    "decision-boundary grid")
        worst_gap = float("inf")
    return {"bias_gap": bias_gap, "worst_gap": worst_gap}
