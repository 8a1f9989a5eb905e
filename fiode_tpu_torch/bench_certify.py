"""Secondary benchmark: CROWN grid cells certified per second on one card
(counterpart of the JAX package's ``bench_certify.py``).

    python -m fiode_tpu_torch.bench_certify [--seed 0]

The metric is the JAX bench's: throughput of the certification pipeline per
(image, grid cell) pair.  A cell is the CROWN backward bounds of the
10 -> 128 -> 128 -> 10 ReLU dynamics twin over the 1/T Linf cell box
(``verify/crown.crown_mlp_bounds``), the diag-swapped interval propagation
through the barrier QP (``verify/ibp_qp.ibp_cbf_qp``: 2 n bisections of 30
steps), and the runner-up worst-case Vdot (``worst_case_vdot``).  The
inputs are the JAX bench's draws, bit for bit (``inputs``): random weights,
``N_IMAGES`` image biases and ``CHUNK`` simplex cells from
``np.random.default_rng(seed)``, in its order and scaling.  The images are
batched into the same products, as rows (images x cells).

Protocol: a call is ``N_INNER`` chunks, the i-th on eta + float32(i) 1e-6
(``sweep``), the per-image max kept; one warm-up call, then ``N_OUTER``
timed calls on the host clock, each ending in a host read of the worst
values, which must be finite (or the program raises).  ``value`` is
N_INNER x CHUNK x N_IMAGES / seconds of the best call; the median and every
call's ms are printed beside it.  One more call runs under torch.profiler
for ``device_busy_frac`` (busy over the best call's wall time).

Precision: float32 only.  The sweep runs under
``verify.certify.float32_matmuls()``, TF32 off for matmuls and cuDNN and
the process's switches restored after; the program switches TF32 on before
one extra sweep and checks both (``tf32_check``).  The JAX bench's
``--precision`` choices and ``mxu_pass_factor`` are left behind, with its
stall-resilient retries.

Work counted from the shapes (``flops_per_cell``), products at 2 flops a
multiply-add, for n = 10, m = 128:

  * CROWN, layer 1: the centre eta W1^T, 2 n m;
  * layer 2 (its sign split collapsed into two products of each kind):
    (u + l) W2^T and (u - l) |W2|^T, 2 x 2 m^2; the (k, in) forms times
    W2^T and |W2|^T, 2 x 2 n m^2; the concretisation, 2 x 2 n m;
  * layer 3: per absorbed ReLU four relaxation einsums and two bias
    einsums on (n, m) forms, 2 x 12 n m; the forms times W2 and W1,
    2 x 2 n m^2 and 2 x 2 n^2 m; the concretisation, 2 x 2 n^2;
  * the interval QP: 2 n cone projections of n lanes, 3 flops a lane and
    step over 30 steps.

That is 30 n m + 4 m^2 + 8 n m^2 + 4 n^2 m + 4 n^2 = 1,466,256 flops of
products and 18,000 of bisection, 1,484,256 a cell.  Elementwise work (the
ReLU relaxation, clamps, the barrier's exp, the Vdot reduction) is not
counted.  With TF32 off the products run on the float32 units, so ``mfu``
is the achieved rate over the H100's published float32 peak, 67 TFLOP/s
(``peak_flops``); ``pct_peak_hbm`` counts the inputs read once and the
worst values written once, over 3.35 TB/s.

Prints everything but its result on stderr, and as the one line on stdout
the JAX bench's record (``metric``, ``value``, ``unit``, ``vs_baseline``
over its ``REF_CELLS_PER_SEC``, ``qp_method``) with the card's numbers and
``device`` (its name and power limit) beside it.  Without a card it exits
non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import functools
import json
import statistics
import sys
import time
from unittest import mock

import numpy as np
import torch

from ._bench_common import (FP32_FLOPS, HBM_BYTES, card, device_breakdown,
                            require_cuda)
from .verify.certify import float32_matmuls
from .verify.crown import crown_mlp_bounds
from .verify.ibp_qp import ibp_cbf_qp, worst_case_vdot

__all__ = ["inputs", "sweep", "measure", "tf32_check", "flops_per_cell",
           "record", "main"]

# the JAX bench's constants (bench_certify.py): its baseline, sizes, metric
# and unit at float32 matmuls; the QP bisects, as its default method
REF_CELLS_PER_SEC = 50_000.0
CHUNK = 4096
N_IMAGES = 8
N_INNER = 10
N_OUTER = 3
N, M, T = 10, 128, 40
EPS = 1.0 / T
ALPHA_1, SIGMA_1, ALPHA_2 = 100.0, 0.02, 20.0
QP_ITERS = 30
METRIC = "crown_grid_cells_certified_per_sec"
PRECISION = "float32"
UNIT = (f"image-cells/sec (T={T}, n={N}, mlp={M}, {N_IMAGES} images batched, "
        f"{PRECISION} matmuls)")
QP_METHOD = "bisect"
STEP = 1e-6  # the i-th chunk of a call is eta + float32(i) * STEP

log = functools.partial(print, file=sys.stderr, flush=True)


def inputs(seed: int = 0, device="cuda", n_images: int = N_IMAGES,
           chunk: int = CHUNK) -> dict:
    """The JAX bench's draws from ``np.random.default_rng(seed)``, in its
    order: W1 (m, n) / sqrt(n), W2 (m, m) / sqrt(m), W3 (n, m) / sqrt(m)
    (each divided in float32, as the JAX arrays are), the image biases
    (n_images, m), then ``chunk`` cells on the simplex (exponential rows,
    normalised); zero biases; labels i mod n.  On ``device``."""
    device = require_cuda(device)
    rng = np.random.default_rng(seed)
    n, m = N, M
    Ws = [rng.normal(size=(m, n)).astype(np.float32) / np.float32(np.sqrt(n)),
          rng.normal(size=(m, m)).astype(np.float32) / np.float32(np.sqrt(m)),
          rng.normal(size=(n, m)).astype(np.float32) / np.float32(np.sqrt(m))]
    x_biases = rng.normal(size=(n_images, m)).astype(np.float32)
    eta = rng.exponential(size=(chunk, n)).astype(np.float32)
    eta /= eta.sum(1, keepdims=True)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return {"Ws": [t(W) for W in Ws],
            "bs": [torch.zeros(k, device=device) for k in (m, m, n)],
            "x_biases": t(x_biases),
            "labels": torch.arange(n_images, device=device) % n,
            "eta": t(eta)}


def sweep(Ws, bs, x_biases, labels, eta, n_inner: int = N_INNER,
          eps: float = EPS) -> torch.Tensor:
    """``n_inner`` chunks of CROWN -> interval QP -> worst-case Vdot for
    every image (x_biases (I, m), labels (I,)) on the cells eta (C, n), the
    i-th chunk on eta + float32(i) 1e-6; the images' rows batched as I x C.
    Float32 matmuls, without autograd.  Returns the per-image max (I,)."""
    I, C = x_biases.shape[0], eta.shape[0]
    n, m = eta.shape[1], x_biases.shape[1]
    x_rows = x_biases[:, None, :].expand(I, C, m).reshape(I * C, m)
    label_rows = labels[:, None].expand(I, C).reshape(I * C)
    worst = torch.full((I,), float("-inf"), device=eta.device)
    with torch.no_grad(), float32_matmuls():
        for i in range(n_inner):
            e = eta + float(np.float32(i) * np.float32(STEP))
            e = e.expand(I, C, n).reshape(I * C, n)
            lb, ub = crown_mlp_bounds(Ws, bs, e, eps, x_rows)
            f_lb, f_ub = ibp_cbf_qp(e, eps, lb, ub, ALPHA_1, SIGMA_1, ALPHA_2)
            v = worst_case_vdot(e, eps, f_lb, f_ub, label_rows).view(I, C)
            worst = torch.maximum(worst, v.amax(1))
    return worst


def _call(inp: dict, n_inner: int) -> torch.Tensor:
    """One call of ``sweep``, ended by a host read; raises on a non-finite
    worst value."""
    worst = sweep(inp["Ws"], inp["bs"], inp["x_biases"], inp["labels"],
                  inp["eta"], n_inner)
    if not bool(torch.isfinite(worst).all()):
        raise RuntimeError(f"the sweep's worst values are not finite: "
                           f"{worst.tolist()}")
    return worst


def measure(inp: dict, n_inner: int = N_INNER, n_outer: int = N_OUTER) -> dict:
    """One warm-up call, then ``n_outer`` timed calls on the host clock.
    Returns every call's ms and the last call's worst values."""
    _call(inp, n_inner)
    call_ms = []
    for _ in range(n_outer):
        if inp["eta"].is_cuda:
            torch.cuda.synchronize(inp["eta"].device)
        t0 = time.perf_counter()
        worst = _call(inp, n_inner)
        call_ms.append(1e3 * (time.perf_counter() - t0))
    return {"call_ms": call_ms, "worst": worst.tolist()}


def tf32_check(inp: dict) -> dict:
    """One sweep with TF32 switched on in the process: the switches seen
    inside it (at every CROWN call) and after it.  Raises unless TF32 was
    off inside and on again after; leaves TF32 off."""
    seen = []

    def spy(*args, **kw):
        seen.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32))
        return bounds(*args, **kw)

    bounds = crown_mlp_bounds

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        with mock.patch.dict(sweep.__globals__, {"crown_mlp_bounds": spy}):
            _call(inp, 1)
        after = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    inside = sorted(set(seen))
    if inside != [(False, False)] or after != (True, True):
        raise RuntimeError(f"TF32 inside the sweep {inside}, after it {after}")
    return {"inside": [list(s) for s in inside], "after": list(after)}


def flops_per_cell(n: int = N, m: int = M, qp_iters: int = QP_ITERS) -> dict:
    """Flops of one (image, cell), counted from the shapes as the module
    docstring writes them out: ``products`` (CROWN) and ``bisection`` (the
    interval QP)."""
    layer1 = 2 * n * m
    layer2 = 2 * 2 * m * m + 2 * 2 * n * m * m + 2 * 2 * n * m
    layer3 = (2 * 12 * n * m + 2 * 2 * n * m * m + 2 * 2 * n * n * m
              + 2 * 2 * n * n)
    return {"products": layer1 + layer2 + layer3,
            "bisection": 2 * n * 3 * n * qp_iters}


def record(result: dict, inp: dict, n_inner: int, busy_ms: float, tf32: dict,
           device: dict) -> dict:
    """The JSON record: the JAX bench's keys from ``measure``'s ``result`` on
    inputs ``inp``, with the calls' times, the work counted from shapes, the
    device-busy share (``busy_ms`` of one profiled call), the TF32 check
    and the card."""
    I, C = inp["x_biases"].shape[0], inp["eta"].shape[0]
    cells = n_inner * C * I
    dt = min(result["call_ms"]) / 1e3
    value = cells / dt
    per_cell = sum(flops_per_cell().values())
    n_bytes = sum(t.numel() * t.element_size()
                  for t in (*inp["Ws"], *inp["bs"], inp["x_biases"],
                            inp["labels"], inp["eta"])) + 4 * I
    t_ops, t_bytes = cells * per_cell / FP32_FLOPS, n_bytes / HBM_BYTES
    return {
        "metric": METRIC,
        "value": value,
        "unit": UNIT,
        "vs_baseline": value / REF_CELLS_PER_SEC,
        "qp_method": QP_METHOD,
        "images": I,
        "chunk": C,
        "n_inner": n_inner,
        "n_outer": len(result["call_ms"]),
        "best_ms": 1e3 * dt,
        "median_ms": statistics.median(result["call_ms"]),
        "call_ms": result["call_ms"],
        "worst": result["worst"],
        "flops_per_cell": per_cell,
        "program_tflops": cells * per_cell / 1e12,
        "achieved_tflops_per_s": cells * per_cell / dt / 1e12,
        "mfu": t_ops / dt,
        "peak_flops": FP32_FLOPS,
        "pct_peak_hbm": 100 * t_bytes / dt,
        "bound": "operations" if t_ops >= t_bytes else "bytes",
        # None where the profiler saw no device time
        "device_busy_frac": busy_ms / (1e3 * dt) if busy_ms > 0 else None,
        "tf32": tf32,
        "device": {"name": device["name"], "power_limit_w": device["power_limit_w"]},
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights and the cells (default 0)")
    args = ap.parse_args(argv)
    try:
        device = require_cuda("cuda")
    except RuntimeError as e:
        raise SystemExit(f"fiode_tpu_torch.bench_certify: {e}")
    info = card()
    log(f"[bench_certify] {info['line']} | torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    inp = inputs(args.seed, device)
    tf32 = tf32_check(inp)
    result = measure(inp)
    log(f"[bench_certify] {inp['x_biases'].shape[0]} images x "
        f"{inp['eta'].shape[0]} cells x {N_INNER}: calls "
        f"{[round(ms, 3) for ms in result['call_ms']]} ms | worst "
        f"{[round(w, 6) for w in result['worst']]} | TF32 inside the sweep "
        f"{tf32['inside']}, after it {tf32['after']}")
    wall, busy, top, _ = device_breakdown(lambda: _call(inp, N_INNER), top=5)
    if busy > 0:
        log(f"[bench_certify] one call under torch.profiler: wall {wall:.1f} ms, "
            f"device busy {busy:.1f} ms")
        for name, ms in top:
            log(f"[bench_certify]   {ms:8.3f} ms  {name[:100]}")
    else:
        log("[bench_certify] device busy: not measured (the profiler saw no "
            "device time)")
    print(json.dumps(record(result, inp, N_INNER, busy, tf32, info)), flush=True)


if __name__ == "__main__":
    main()
