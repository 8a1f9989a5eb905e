#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (fiode_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from fiode_tpu_torch/csrc (K1 and K2
in fused_rhs.cu, once per state width; K3 in fused_cayley_conv.cu; K4 in
fused_crown.cu and K5 in fused_qp.cu at the certify configuration's
widths), prints
ptxas's registers and spills, holds each kernel against its plain PyTorch
version at the shapes its paths give it, and drives two paths through the
kernels and through the plain path, checking that the kernels carried each
and timing both:

  * phases 3-6: the flagship forward solve (KWLarge Cayley backbone ->
    simplex neural ODE, dopri5), K1 and K3; phase 3 also holds K1 at a wide
    state (n = 100) and, with the plain version, against float64; phase 4
    also holds K3 at the transposed flagship shapes and at the MNIST
    KWLarge's; phase 6 times K1 (device time from torch.profiler) and each
    conv layer's K3 forward and transposed launch against the plain
    version, torch.fft and the bound, and profiles one solve: device busy,
    idle share, the costliest kernels, and the PyTorch operators by input
    shape;
  * phases 7-10: gradients through the solve of the certified configuration
    (ReLU dynamics, scale_nominal off, t_max 0.1, max_steps 8) and of the
    flagship (scale_nominal on), and the AutoAttack standard suite on the
    trained checkpoint (run_data/certified_full/ckpt/best_torch.npz) at the
    protocol of autoattack_full_standard_512_tmax01.json (apgd-ce, apgd-t,
    fab-t, square; the 512 synthetic test images, L2 eps 0.141, 100
    iterations, 5000 Square queries, t_max 0.1, max_steps 8), held to the
    certificate: an adversarial validated on a certified image (all but
    the 35 open_images of refine_accounting.json) fails the run: K2
    (scale_nominal off and on), K3 on Q^H as the conv backward, and K1 and
    K3 in every attack forward;
  * phases 11-13: certification on the trained checkpoint
    (run_data/certified_full/ckpt/best_torch.npz) and the synthetic test
    set (seed 0, 512 images) over the whole n = 10, T = 40 grid
    (41,320,837 cells): the grid enumeration (built with g++) and 512/512
    clean (11); the CROWN sweep on test images 4-11, held to the certified
    set of run_data/certified_full/certify_stream_full_rep2.jsonl.json,
    with one block's device time by stage and its peak memory, K4 (CROWN's
    bounds) and K5 (the interval QP), one launch each a chunk (k4.launches,
    k5.launches over the sweep), each against its plain path at one
    chunk's rows, with its time, its bound and the plain path's time
    (12); the Lipschitz / larger-T
    sweep and exact_witness on test images 0-15 through K1, held to
    lips_stream_full.jsonl.json and exact_witnesses.json, with blocks
    through K1 against the same blocks through rhs_reference (13);
  * phase 14: branch-and-bound refinement on the same checkpoint, grid and
    images at the budgets of the committed passes: CROWN BaB on test images
    15, 95 and 221 (refine_full_pass5_stream.jsonl), the hybrid bound (K1
    at every cell and box centre) on image 15 (hybrid_sweep_stream.jsonl),
    and the Lipschitz BaB on images 3 and 7 (refine_lips_probe.json), each
    held to the verdict, violated cells and rounds or give-up of the JAX
    package in float32 (the artifacts' TPU counts printed beside); one
    round's device breakdown.

  * phase 15: Lyapunov certified training.  run_train on
    configs/classification/cifar_train.yaml at full width (KWLarge, mlp
    128, B 128, S 256: 32,768 Lyapunov rows a step) on the synthetic CIFAR
    set for 2 of its 300 epochs, validating and checkpointing each, then
    the test evaluation: the loss falls, every loss is finite, K3 launches
    7 times a step (4 forward, 3 on Q^H); one Lyapunov step through the
    kernels against the plain path from the same state and draws; two
    steps of the ode objective (K1, and K2 with weight gradients once per
    RHS evaluation) against the plain backward and bit-stable; a run
    resumed from epoch 1 equal to the uninterrupted one; the best
    checkpoint through entry.certify_model; a few steps of
    mnist_train.yaml at full width (K3's direct passes); the step's host
    time, device time by stage, idle share and peak memory.  15f: the
    trainer's other modes on the same configuration: two steps each of
    adv_train (PGD-7 on the Lyapunov objective), lips_train (on KWLarge,
    whose constant is 1, and on its 4C3F twin, where the power iteration
    runs), the train_ode blend at ode_portion 0.5 (K1, K2) and adv_train +
    lips_train, the first step's loss through the kernels against the
    plain path and its gradients by the kernels and by the plain VJPs on
    one shared forward (on the kernel path's adversarial batch; each
    leaf's largest gap over the larger of its own largest value and a
    hundredth of the median leaf's), its launches checked against what the trainer's code implies, each step's
    host time, device busy and peak memory; val_adv's evaluate on one
    batch of 256 with 15a's trained weights (PGD-5 through the solve: K1,
    K2, K3 and K3 on Q^H); run_train with adv_train, val_adv and
    lips_train for one epoch of 1,024 images, its best checkpoint
    following validation_adv_error.

Phase 4 also holds K3 at a spatial size past the radix path's 32 (n = 64)
and times it; phase 5 also checks that a solve in training mode equals the
eval-mode solve.

  * phase 16: the Segway safe controller (run_data/segway/segway_f32.npz,
    trained by the JAX package in float32; tools/export_segway_reference.py):
    the port certifies it at r = 0.01 and r = 0.0025 and simulates its five
    fixed starts, held to the JAX package's answers in segway_f32.json
    (16a); the port trains from seed 0 at examples/segway_workflow.py's
    protocol (300 LQR-fit and 300 barrier iterations with Linf PGD, eps
    0.02), then certifies at r = 0.01 and simulates (16b); the times per
    iteration, of one barrier step on the device, of certification and of
    the simulation (16c).  No TPU kernel is on this path: K1-K3 launch 0
    times, and the kernels line does not count the phase.

  * phase 17: the rest of the ODE and model layer.  17a: the flagship at
    B = 32768 with every adaptive method (dopri5, dopri8, bosh3, fehlberg2,
    adaptive_heun) and every fixed-grid one (euler, midpoint, rk4, the
    three Adams forms; step 0.1) through the kernels and the plain path:
    endpoints within 1e-3, step counts equal or apart only where the error
    ratio of both lies within RATIO_ROUNDING of 1.  17b: d(mean CE)/dx by
    the continuous adjoint (K1 then K2 in the augmented RHS) against the
    plain adjoint, for the trained certify configuration and the flagship
    at t_max 0.1, B = 512, with phase 9's rule for GroupSort flips; the
    cosine to the discrete gradient; the flagship at t_max 1 printed only
    (its backward solve cannot reconstruct y: the y(0) error printed).
    17c: the cached twin of best_torch.npz against the model at B = 32768:
    predictions within 1e-6, 4 K3 launches a forward, no Cayley solve in
    its profiled backbone forward (the model's shows them).  17d:
    ConvBlockDynamics(32), basic and bottleneck, on (512, 3, 32, 32), rk4
    to t = 0.5 on the card against the CPU.

  * phase 18: the command line, ``python -m fiode_tpu_torch`` in
    subprocesses on the card (each reporting its kernels' launches):
    certify-crown of test image 4 over the whole grid against the artifact
    and summarize-stream of its log (18a), certify-lipschitz of images 0-3
    against the same sweep in this process and the artifact (18b),
    eval-autoattack of 64 images with apgd-ce and apgd-t at t_max 0.1 that
    breaks no certified image (18c), one epoch of cifar_train.yaml and
    certify-lipschitz restoring its best.npz (18d), the same epoch under
    torch.distributed.run on one NCCL rank, equal to 18d (18e),
    segway-certify at r = 0.01 with its figures against segway_f32.json
    (18f), and, in this process, the Certifier on a mesh of the card
    ([cuda:0] x 2 over cells, a 1 x 1 img x cell mesh) against the
    unsharded sweep (18g).

  * phase 19: the example drivers, ``python -m
    fiode_tpu_torch.examples.<name>`` in subprocesses on the card, all at
    once (each reporting its kernels' launches, outputs under
    chiprun_out/drivers/): full_workflow restoring the trained checkpoint,
    CROWN and Lipschitz on
    test images 0-3 over the whole T = 40 grid held to the committed
    streams, 64 images attacked, certified ⊆ robust (19a); full_workflow
    training one epoch of cifar_train.yaml at full width (19b);
    segway_workflow at the full protocol, its verdict held to phase 16b's
    (19c); hybrid_sweep (image 502, certified),
    refute_witnesses (image 11, the float32 witness), refine_workflow
    (image 15 in 2 rounds, held to phase 14's float32 answer),
    refine_lips_workflow (image 3 in 2 rounds, held to phase 14c's float32
    answer), alpha_crown_demo and alpha_probe, then
    examples/refine_accounting.py and examples/inclusion_check.py on their
    output (19d); dryrun_multichip on two ranks of the card, gloo over its
    CUDA tensors (19e).  run_data/certified_full/ must be byte-equal after.

Launches are read as deltas of the kernel wrappers' counters
(fiode_tpu_torch/utils/tracing.py), k1.launches to k5.launches, under those
names (``launched``).  The timings here are bring-up checks of each kernel
against its plain version and its bound (the kernel table's yardstick:
products at the 3xTF32 rate); the port's end-to-end speed is measured by
the benchmark, ``python3 perfbench/run.py`` (cells in BENCHMARK.json).

``--phases certify`` runs phases 1, 2 and 11-14 only, for work on the
certification path, ``--phases train`` phases 1, 2 and 15 (15f included), ``--phases
control`` phases 1 and 16 (no build), ``--phases attack`` phases 1, 2 and
10, ``--phases ode`` phases 1, 2 and 17, ``--phases cli`` phases 1, 2
and 18, and ``--phases drivers`` phases 1, 2 and 19; none prints a result
line.

No phase catches its own failure.  Without a CUDA device it exits non-zero
and prints no result.

The second-to-last line of stdout is a JSON object describing each kernel
(its time, launches, error, plain-version time, bound and library-call
time), the last line the contract object
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

import torch

try:  # the package beside this script; nothing else of the repo is imported
    from fiode_tpu_torch.utils.tracing import counters
except ModuleNotFoundError as e:
    raise SystemExit(f"chip_smoke: no fiode_tpu_torch package beside {__file__} ({e})")

ROOT = Path(__file__).resolve().parent
SEED = 0
N_CLASSES, MLP = 10, 128
WIDE_N = 100  # phase 3 also holds K1 at a wide state (the JAX kernel takes n <= 128)
K1_BATCH, K3_BATCH, E2E_BATCH, TIME_BATCH = 4096, 64, 4096, 32768
K1_TOL, K3_TOL, E2E_TOL = 2e-4, 1e-4, 1e-3
MAX_SPILL_BYTES = 16  # spill stores a main-path kernel of fused_rhs.cu may have
# K4 against its plain path at a chunk of the trained checkpoint's sweep:
# the gap of a row's bounds over their largest magnitude, and the rows that
# may exceed it (a neuron within round-off of u = -l takes either slope)
K4_TOL, K4_TIED_ROWS = 1e-5, 8
# K5 against the plain interval QP on that chunk's bounds: the largest gap
# over the bounds' largest magnitude (the two differ only in the order of
# each row's sum of n terms, which moves where the bisection stalls by a
# few float32 spacings)
K5_TOL = 1e-5
# (ci, co, k, n) of the flagship's four CayleyConv applies (after
# space_to_depth for the strided ones)
CONV_SHAPES = ((3, 32, 3, 32), (128, 32, 2, 16), (32, 64, 3, 16),
               (256, 64, 2, 8))
# the same for the MNIST KWLarge (configs/certify/mnist_certify.yaml:
# KWLargeBackbone(in_channels=1, img_size=28))
MNIST_CONV_SHAPES = ((1, 32, 3, 28), (128, 32, 2, 14), (32, 64, 3, 14),
                     (256, 64, 2, 7))
# phases 7-10: the certified configuration and the attack protocol of
# run_data/certified_full/autoattack_full_standard_512_tmax01.json
T_MAX, MAX_STEPS = 0.1, 8
K2_BATCH, K2_TOL = 4096 + 17, 1e-4
K3_BWD_BATCH, K3_BWD_TIME_BATCH = 64, 4096
GRAD_BATCH, GRAD_LOSS_TOL, GRAD_DX_TOL = 512, 1e-3, 5e-3
# phase 9 excludes images whose GroupSort pairs took another branch on the
# two paths; more than this share of them means the forwards drifted apart
GRAD_MAX_FLIPPED = 0.05
ATTACK_IMAGES, ATTACK_EPS, ATTACK_ITERS, SQUARE_QUERIES = 512, 0.141, 100, 5000
# K2 checks give a zero cotangent to rows whose float64 pre-activations lie
# this close to a ReLU kink, or whose projection lanes this close to the
# active-set boundary: there the gradient jumps, and two correct float32
# evaluations (the kernel's and cuBLAS's sum orders) may take different sides
KINK_MARGIN, ACTIVE_MARGIN = 1e-5, 1e-4
# phases 11-13: the certification protocol of run_data/certified_full
# (configs/certify/cifar_certify.yaml: T 40, eps 0.141, t_max 1, chunk 8192)
CERT_DIR = ROOT / "run_data" / "certified_full"
CERT_T, CERT_EPS, CERT_CHUNK, CERT_CELLS = 40, 0.141, 8192, 41_320_837
CERT_T_MAX, CERT_MAX_STEPS = 1.0, 64
CROWN_IMAGES = range(4, 12)  # the artifact certifies 4, 5, 6, 8, 9, 10; not 7, 11
LIPS_IMAGES = range(0, 16)
# an image whose worst value lies this close to zero is held by its margin,
# any other by its verdict; K1 blocks against plain blocks at the same
CERT_MARGIN = 1e-4
# phase 14: refinement at the budgets of the committed passes.  Their
# violated counts came from a TPU whose backbone features were not
# float32-exact, so the gates hold the JAX package's float32 answers on the
# CPU for the same cells (tools/refine_cells_dump.py on the card, then
# tools/refine_float32_reference.py) and print the artifacts' beside them.
# CROWN BaB, all certified: image -> (violated cells, rounds, boxes)
REFINE_IMAGES = (15, 95, 221)
REFINE_F32 = {15: (12, 2, 36), 95: (8529, 2, 25587), 221: (8467, 3, 25425)}
REFINE_BUDGETS = dict(alpha_iters=0, lips_box=False, max_rounds=60,
                      collect_cap=16_000_000, frontier_cap=1 << 26,
                      box_budget=2_000_000_000)
# violated counts of two float32 evaluations differ by the cells within
# their round-off of zero (~2e-5 a cell; a ReLU slope choice flips on a few)
REFINE_VIOLATED_TOL = 5e-3
# the hybrid bound on image 15 (hybrid_sweep_stream.jsonl: 69 violated,
# worst +0.006005 on the TPU); float32: violated cells, worst
HYBRID_IMAGE, HYBRID_F32, HYBRID_ARTIFACT = 15, (12, 0.003029), (69, 0.006005)
# the Lipschitz BaB (refine_lips_probe.json): image 7 exceeds the collect
# cap (float32: every cell violated); image 3, cut to two rounds here,
# gives up with its violated cells (float32 and the artifact alike)
LIPS_REFINE_BUDGETS = dict(collect_cap=12_000_000, box_budget=128_000_000,
                           frontier_cap=1 << 25)
LIPS_REFINE_IMAGES, LIPS_REFINE_ROUNDS = (7, 3), 2
LIPS_REFINE_F32, LIPS_REFINE_ARTIFACT = 5_475_963, 5_475_963
# phase 4: K3 past the radix path's spatial sizes
K3_WIDE = (16, 16, 3, 64)


def log(msg: str) -> None:
    print(msg, flush=True)


def gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


# the kernel table's yardstick: the H100 SXM's published peaks (NVIDIA data
# sheet, dense, 700 W): float32 outside the tensor cores, TF32 on the tensor
# cores, HBM3; a kernel's bound is the larger of its bytes (each input read
# once, each output written once) over the memory rate and its flops over
# the peak rate of the unit that runs them: the products of K1 and K2 and
# K3's mix run on the tensor cores in 3xTF32, three TF32 products per
# float32 product; K1's and K2's bisection runs on float32 lanes.  The
# benchmark's rooflines (perfbench/work.py) count the same bytes and flops
# but take the products at the TF32 peak.
FP32_FLOPS, TF32_FLOPS, HBM_BYTES = 67e12, 495e12, 3.35e12


def bound_ms(n_bytes: float, flops: float, rate: float = FP32_FLOPS) -> tuple:
    """(least milliseconds, "bytes" or "operations") for flops at rate."""
    t_bytes, t_ops = n_bytes / HBM_BYTES, flops / rate
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def conv_bound(B, ci, co, n) -> tuple:
    """Bound of one K3 apply: x and y once, Q once; the mix's 8 F co ci
    flops per image at the 3xTF32 rate (a third of the TF32 peak); the
    transforms' flops are not counted."""
    F = n * (n // 2 + 1)
    return bound_ms(4 * B * (ci + co) * n * n + 8 * F * co * ci,
                    8 * B * F * co * ci, TF32_FLOPS / 3)


def rhs_flops(n, m, qp_iters, backward=False, weight_grads=False) -> tuple:
    """Flops per batch row of K1 (and of K2, which recomputes K1), as (the
    products', the bisection's): three products forward; backward adds
    d pre2, d pre1 and dh, and the weight gradients dW3, dW2 and dW1."""
    products = 2 * n * m + 2 * m * m + 2 * m * n
    if backward:
        products *= 3 if weight_grads else 2
    return products, 3 * n * qp_iters


def rhs_bound(B, n, m, qp_iters, backward=False, weight_grads=False) -> tuple:
    """Bound of one K1 or K2 launch: rows and weights once over the memory
    rate; the products' flops at the 3xTF32 rate (a third of the TF32 peak)
    plus the bisection's at the float32 rate."""
    weights = 4 * (2 * m * n + m * m + m + n)
    rows = 4 * B * ((n + m + n + n + m) if backward else (n + m + n))
    products, bisection = rhs_flops(n, m, qp_iters, backward, weight_grads)
    t_bytes = (rows + weights * (2 if weight_grads else 1)) / HBM_BYTES
    t_ops = B * (products / (TF32_FLOPS / 3) + bisection / FP32_FLOPS)
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def crown_flops(n, m) -> int:
    """Flops of CROWN's products per row of the n -> m -> m -> n ReLU MLP,
    counted dense (K4 skips the neurons that add nothing): layer 1's
    centre; layer 2's sign split collapsed into two products of each kind,
    its forms and concretisation; layer 3's relaxation and bias einsums,
    its forms times W2 and W1 and its concretisation."""
    layer1 = 2 * n * m
    layer2 = 2 * 2 * m * m + 2 * 2 * n * m * m + 2 * 2 * n * m
    layer3 = (2 * 12 * n * m + 2 * 2 * n * m * m + 2 * 2 * n * n * m
              + 2 * 2 * n * n)
    return layer1 + layer2 + layer3


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device milliseconds per call of ``fn`` (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_us(e) -> float:
    us = getattr(e, "device_time_total", None)
    return getattr(e, "cuda_time_total", 0) if us is None else us


def kernel_ms(fn, tags: tuple, iters: int = 20) -> float:
    """Device milliseconds per call of ``fn`` spent in the kernels whose
    names contain one of ``tags``, from torch.profiler: a launch shorter than
    the host's work per call (~0.06 ms through the autograd wrapper) cannot
    be timed between two events.  Falls back to ``cuda_ms`` if the profiler
    saw no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(_device_us(e) for e in prof.key_averages()
             if any(tag in e.key for tag in tags))
    return us / 1e3 / iters if us > 0 else cuda_ms(fn, iters)


def range_names(events) -> set:
    """The names of the profiler ranges (the program's spans, the
    optimizer's own) among a profiler's events.  Each range also shows on
    the device's timeline, as an event of its name that is no device
    operation and may lack the user-annotation flag."""
    return {e.name for e in events
            if not str(getattr(e, "device_type", "")).endswith("CUDA")
            and getattr(e, "is_user_annotation", False)}


def is_device_op(e, ranges: set) -> bool:
    """Whether profiler event ``e`` is an operation of the device's own (a
    kernel, copy or set), not a range's copy: ``ranges`` from
    ``range_names``."""
    return (str(getattr(e, "device_type", "")).endswith("CUDA")
            and not getattr(e, "is_user_annotation", False)
            and e.name not in ranges)


def device_breakdown(fn, top: int = 8, top_ops: int = 14) -> tuple:
    """Run fn once under torch.profiler: (wall ms, device-busy ms, the top
    kernels as (name, ms), the top operators as (name, input shapes, calls,
    ms)).  The kernels are summed over the device's own kernel events only,
    so that no time is counted twice through the ops that launched them; an
    operator's time is that of the kernels it launched itself (not its
    children's), grouped by operator and input shapes.  Kernels launched
    outside any PyTorch operator (K1, K3) appear only among the kernels.
    The device-side copies of profiler ranges are left out of
    both."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    ranges = range_names(prof.events())
    rows = [(e.key, _device_us(e) / 1e3) for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")
            and e.key not in ranges]
    rows.sort(key=lambda r: -r[1])
    ops = []
    for e in prof.key_averages(group_by_input_shape=True):
        if (str(getattr(e, "device_type", "")).endswith("CUDA")
                or e.key in ranges):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            ops.append((e.key, str(e.input_shapes), e.count, us / 1e3))
    ops.sort(key=lambda r: -r[3])
    return wall, sum(ms for _, ms in rows), rows[:top], ops[:top_ops]


# the kernel wrappers' launch counters (fiode_tpu_torch/utils/tracing.py),
# K1 to K5; K1_K3 those of the solve's kernels
LAUNCHES = tuple(f"k{i}.launches" for i in range(1, 6))
K1_K3 = LAUNCHES[:3]
# the train step's CUDA graph (fiode_tpu_torch/train/step_graph.py)
GRAPH_COUNTS = ("train.graph_captures", "train.graph_replays")


def launched(before: dict, names: tuple = LAUNCHES) -> dict:
    """Each counter of ``names`` moved since ``before``, a ``counters()``
    taken earlier: its launches in between, 0 for a kernel that did not
    launch."""
    now = counters()
    return {k: now.get(k, 0) - before.get(k, 0) for k in names}


def plain_freq_apply(x, Qr, Qi):
    """fused_freq_apply by its plain version (the dense DFT, no K3)."""
    from fiode_tpu_torch.ops.cayley import apply_freq_matrices
    return apply_freq_matrices(x, torch.complex(Qr, Qi), impl="dft")


def plain_rhs_vjp(h, xc, g, p, *consts, weight_grads=True):
    """fused_rhs_vjp by its plain version (no K2)."""
    from fiode_tpu_torch.ops.fused_rhs import rhs_vjp_reference
    dh, dxc, dp = rhs_vjp_reference(h, xc, g, p, *consts)
    return dh, dxc, dp if weight_grads else None


@contextlib.contextmanager
def plain_path():
    """Run solves with K1 and K3 replaced by their plain versions; their
    backward is then autograd through the plain versions (no K2), and the
    adjoint's augmented RHS takes the plain versions of K1 and K2.  Raises
    if K1, K2 or K3 launched inside."""
    from fiode_tpu_torch.models import ivp, layers
    from fiode_tpu_torch.ops.fused_rhs import rhs_reference
    before = counters()
    with mock.patch.object(ivp, "fused_rhs", rhs_reference), \
            mock.patch.object(ivp, "fused_rhs_vjp", plain_rhs_vjp), \
            mock.patch.object(layers, "fused_freq_apply", plain_freq_apply):
        yield
    if any(launched(before, K1_K3).values()):
        raise RuntimeError("the plain path launched a kernel")


def card() -> dict:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them for
    device 0 (``line``; ``power_limit_w`` a number, or None if nvidia-smi
    printed none), or ``torch.cuda.get_device_name(0)`` alone where
    nvidia-smi is missing."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[0]
    except FileNotFoundError:
        name = torch.cuda.get_device_name(0)
        return {"name": name, "power_limit_w": None, "line": name}
    name, _, limit = out.rpartition(",")
    try:
        watts = float(limit.strip().split()[0])
    except (IndexError, ValueError):  # "[N/A]" and the like
        watts = None
    return {"name": name.strip(), "power_limit_w": watts, "line": out}


K1_KERNELS = ("fused_rhs_kernel",)
K2_KERNELS = ("fused_rhs_backward_kernel", "reduce_slots_kernel")


def k3_stage_ms(run, x, iters: int = 3) -> dict:
    """Device milliseconds per apply of each of K3's three launches
    (forward transform, mix, inverse transform), from torch.profiler; empty
    if the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile
    run(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            run(x)
        torch.cuda.synchronize()
    stages = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        for stage, tag in (("irdft", "irdft"), ("mix", "mix_kernel"), ("rdft", "rdft")):
            if tag in e.key:
                stages[stage] = stages.get(stage, 0.0) + us / 1e3 / iters
                break
    return stages


def rhs_weights(dyn):
    from fiode_tpu_torch.models.dynamics import densify_dynamics_params
    from fiode_tpu_torch.ops.fused_rhs import pack_rhs_params
    dense = densify_dynamics_params(dyn)
    return pack_rhs_params(dense["hidden_to_mlp"][0], dense["mlp_to_mlp"][0],
                           dense["mlp_to_hidden"][0], dense["mlp_to_mlp"][1],
                           dense["mlp_to_hidden"][1])


def simplex_rows(B, n, seed, dev):
    h = torch.rand(B, n, generator=gen(seed))
    return (h / h.sum(-1, keepdim=True)).to(dev)


def kink_free_cotangent(h, xc, p, dyn, seed, scale_nominal=False):
    """A unit-normal cotangent (B, n) that is zero on rows near a kink (see
    KINK_MARGIN); returns it and the number of such rows."""
    from fiode_tpu_torch.ops.fused_rhs import RhsParams
    from fiode_tpu_torch.ops.simplex_qp import cone_project_mu
    d = [t.double() for t in (h, xc, *p)]
    h64, xc64, q = d[0], d[1], RhsParams(*d[2:])
    pre1 = h64 @ q.W1.T + xc64
    pre2 = torch.relu(pre1) @ q.W2.T + q.b2
    f = torch.relu(pre2) @ q.W3.T + q.b3
    lower = -dyn.alpha_1 * (torch.exp(dyn.sigma_1 * h64) - 1.0)
    if scale_nominal:
        f = (dyn.alpha_2 * (1.0 - h64) - lower) * torch.sigmoid(f) + lower
    margin = (f - cone_project_mu(lower, f, 60)) - lower
    near = ((pre1.abs() < KINK_MARGIN).any(-1)
            | (pre2.abs() < KINK_MARGIN).any(-1)
            | (margin.abs() < ACTIVE_MARGIN).any(-1))
    g = torch.randn(h.shape, generator=gen(seed)).to(h.device)
    return g * (~near)[:, None], int(near.sum())


def k2_phase(dyn, dev) -> dict:
    """[7 K2] the fused RHS backward against rhs_vjp_reference, with the
    squash (scale_nominal) off, as in the certified dynamics, and on."""
    from fiode_tpu_torch.ops.fused_rhs import (fused_rhs, fused_rhs_vjp,
                                               rhs_vjp_reference)
    with torch.no_grad():
        p = rhs_weights(dyn)
        n, m = p.W3.shape
        h = simplex_rows(K2_BATCH, n, 30, dev)
        xc = torch.randn(K2_BATCH, m, generator=gen(31)).to(dev)
        err = 0.0
        for sn, weight_grads in ((False, True), (False, False), (True, True),
                                 (True, False)):
            args = (dyn.alpha_1, dyn.sigma_1, dyn.alpha_2, sn, dyn.qp_iters)
            g, n_near = kink_free_cotangent(h, xc, p, dyn, 32, sn)
            rh, rxc, rp = rhs_vjp_reference(h, xc, g, p, *args)
            dh, dxc, dp = fused_rhs_vjp(h, xc, g, p, *args, weight_grads)
            dh2, dxc2, dp2 = fused_rhs_vjp(h, xc, g, p, *args, weight_grads)
            torch.cuda.synchronize()
            got = [dh, dxc] + list(dp or ())
            again = [dh2, dxc2] + list(dp2 or ())
            if (dp is None) == weight_grads:
                raise RuntimeError("K2 ignored weight_grads")
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise RuntimeError("two K2 launches differ")
            e_rows = max((dh - rh).abs().max().item(),
                         (dxc - rxc).abs().max().item())
            err = max(err, e_rows)
            e_rel = 0.0
            for name, a, b in zip(("dW1", "dW2", "dW3", "db2", "db3"),
                                  dp or (), rp):
                e = ((a - b).abs().max() / b.abs().max()).item()
                e_rel = max(e_rel, e)
            log(f"[7 K2] B={K2_BATCH} n={n} mlp={m} scale_nominal={sn} "
                f"weight_grads={weight_grads}: "
                f"dh/dxc max|d|={e_rows:.3e}, weights max|d|/max={e_rel:.3e} "
                f"(tol {K2_TOL:g}); repeat bit-identical; {n_near} rows near a "
                f"kink given a zero cotangent")
            if not (e_rows <= K2_TOL and e_rel <= K2_TOL):
                raise RuntimeError(f"K2 disagrees with its plain version: "
                                   f"{e_rows} {e_rel}")

        h = simplex_rows(TIME_BATCH, n, 33, dev)
        xc = torch.randn(TIME_BATCH, m, generator=gen(34)).to(dev)
        g = torch.randn(TIME_BATCH, n, generator=gen(35)).to(dev)
        out = {"err": err}
        for sn in (False, True):
            args = (dyn.alpha_1, dyn.sigma_1, dyn.alpha_2, sn, dyn.qp_iters)
            plain = cuda_ms(lambda: rhs_vjp_reference(h, xc, g, p, *args), 20)
            ms = kernel_ms(lambda: fused_rhs_vjp(h, xc, g, p, *args, True),
                           K2_KERNELS)
            ms_x = kernel_ms(lambda: fused_rhs_vjp(h, xc, g, p, *args, False),
                             K2_KERNELS)
            per_call = cuda_ms(lambda: fused_rhs_vjp(h, xc, g, p, *args, False), 20)
            bw, by = rhs_bound(TIME_BATCH, n, m, dyn.qp_iters, True, True)
            bx, byx = rhs_bound(TIME_BATCH, n, m, dyn.qp_iters, True, False)
            log(f"[7 time] K2 B={TIME_BATCH} scale_nominal={sn}: kernel {ms:.4f} "
                f"ms with weight grads (bound {bw:.4f} ms by {by}, "
                f"{100 * bw / ms:.1f}% of it), {ms_x:.4f} ms without (bound "
                f"{bx:.4f} ms by {byx}, {100 * bx / ms_x:.1f}% of it; "
                f"{per_call:.4f} ms per call between events, host included) | "
                f"plain {plain:.4f} ms")
            if not sn:  # the certified dynamics, which the attacks run
                out.update(ms=ms, ms_no_weights=ms_x, plain_ms=plain, bound_ms=bw,
                           bound_by=by)
        # the attacks' batch: one 16-row tile a warp, a launch's latency
        hs, xs, gs = h[:ATTACK_IMAGES], xc[:ATTACK_IMAGES], g[:ATTACK_IMAGES]
        args = (dyn.alpha_1, dyn.sigma_1, dyn.alpha_2, False, dyn.qp_iters)
        small = (kernel_ms(lambda: fused_rhs(hs, xs, p, *args), K1_KERNELS),
                 kernel_ms(lambda: fused_rhs_vjp(hs, xs, gs, p, *args, False),
                           K2_KERNELS),
                 kernel_ms(lambda: fused_rhs_vjp(hs, xs, gs, p, *args, True),
                           K2_KERNELS))
        log(f"[7 time] B={ATTACK_IMAGES} scale_nominal=False: K1 {small[0]:.4f} ms | "
            f"K2 {small[1]:.4f} ms without weight grads, {small[2]:.4f} ms with")
    return out


def k3_backward_phase(model, dev) -> dict:
    """[8 K3 backward] dx of each conv layer by K3 on Q^H against the
    autograd VJP of the plain dense-DFT apply."""
    from fiode_tpu_torch.ops.cayley import cayley_conv_kernel
    from fiode_tpu_torch.ops.fused_cayley_conv import fused_freq_apply
    err = 0.0
    for i, (ci, co, k, n) in enumerate(CONV_SHAPES):
        conv = model.backbone.convs[i]
        with torch.no_grad():
            Q = cayley_conv_kernel(conv.weight, conv.alpha, n)
        Qr, Qi = Q.real.contiguous(), Q.imag.contiguous()

        def grads(B, seed, apply):
            x = torch.randn(B, ci, n, n, generator=gen(seed)).to(dev)
            g = torch.randn(B, co, n, n, generator=gen(seed + 1)).to(dev)
            x.requires_grad_()
            return lambda: torch.autograd.grad(apply(x, Qr, Qi), x, g)[0]

        kern = grads(K3_BWD_BATCH, 40 + i, fused_freq_apply)
        since = counters()
        dx = kern()
        if launched(since)["k3.launches"] != 2:
            raise RuntimeError("K3 backward did not launch K3 on Q^H")
        want = grads(K3_BWD_BATCH, 40 + i, plain_freq_apply)()
        torch.cuda.synchronize()
        e = (dx - want).abs().max().item()
        err = max(err, e)
        t_kern = cuda_ms(grads(K3_BWD_TIME_BATCH, 50 + i, fused_freq_apply), 5)
        t_plain = cuda_ms(grads(K3_BWD_TIME_BATCH, 50 + i, plain_freq_apply), 5)
        log(f"[8 K3 bwd] layer {i} dx {co}->{ci} @{n} B={K3_BWD_BATCH}: "
            f"max|d|={e:.3e} (tol {K3_TOL:g}) | forward + backward at "
            f"B={K3_BWD_TIME_BATCH}: kernel {t_kern:.3f} ms, plain {t_plain:.3f} ms")
        if not e <= K3_TOL:
            raise RuntimeError(f"K3 backward disagrees with the plain VJP: {e}")
    return {"err": err}


@contextlib.contextmanager
def groupsort_branches(model, out: list):
    """Append, for each GroupSort call of the backbone's forwards run inside,
    the branch every pair took (first > second), one row per image."""
    def hook(module, inputs, output):
        a = inputs[0]
        dim = 1 if a.dim() == 4 else a.dim() - 1
        u, v = a.unflatten(dim, (a.shape[dim] // 2, 2)).unbind(dim + 1)
        out.append((u > v).reshape(a.shape[0], -1))

    handle = model.backbone.act.register_forward_hook(hook)
    try:
        yield
    finally:
        handle.remove()


def plain_backward(rhs_ctx, g):
    """_FusedRhsCuda.backward by the plain rhs_vjp_reference (no K2), with
    the weight gradients where the weights need them."""
    from fiode_tpu_torch.ops.fused_rhs import RhsParams, rhs_vjp_reference
    h, xc, *w = rhs_ctx.saved_tensors
    dh, dxc, dp = rhs_vjp_reference(h, xc, g, RhsParams(*w), *rhs_ctx.consts)
    dw = tuple(dp) if any(rhs_ctx.needs_input_grad[2:7]) else (None,) * 5
    return (dh, dxc, *dw) + (None,) * 6


@contextlib.contextmanager
def plain_backwards():
    """Differentiate the kernel path's graph with the plain VJPs of K1 and
    K3 instead of K2 and K3 on Q^H."""
    from fiode_tpu_torch.ops.fused_cayley_conv import _FusedFreqApplyCuda
    from fiode_tpu_torch.ops.fused_rhs import _FusedRhsCuda
    before = counters()
    with mock.patch.object(_FusedRhsCuda, "backward",
                           staticmethod(plain_backward)), \
            mock.patch.object(_FusedFreqApplyCuda, "backward",
                              staticmethod(plain_conv_backward)):
        yield
    torch.cuda.synchronize()
    if any(launched(before, K1_K3).values()):
        raise RuntimeError("the plain backward launched a kernel")


def plain_conv_backward(conv_ctx, g):
    """_FusedFreqApplyCuda.backward by the plain dense-DFT VJP, in x and Q
    where they need it."""
    need = conv_ctx.needs_input_grad[:3]
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(n)
                  for t, n in zip(conv_ctx.saved_tensors, need)]
        got = iter(torch.autograd.grad(plain_freq_apply(*leaves),
                                       [t for t in leaves if t.requires_grad], g))
    return tuple(next(got) if n else None for n in need)


def grad_solve_phase(model, dev) -> dict:
    """[9 gradient through the solve] d(mean CE)/dx, CE of h(t_max) against
    the clean argmax, kernel path against plain path.

    The two forwards differ by float32 round-off (K3 against the dense DFT),
    enough to flip a GroupSort pair that is a near-tie; the gradient of that
    image then jumps, correctly, on one side.  So the path-to-path gate
    holds the images whose GroupSort pairs all took the same branch in both
    forwards, and a second gate holds every image with one forward shared:
    the kernel path's graph, differentiated once by K2 and K3 on Q^H and
    once by their plain VJPs."""
    from fiode_tpu_torch.attacks.apgd import ce_loss
    model.requires_grad_(False)  # as in an attack: gradients in x only
    x = torch.rand(GRAD_BATCH, 3, 32, 32, generator=gen(60)).to(dev)
    with torch.no_grad():
        y = model.predict(x).argmax(-1)

    def loss_and_grad(retain=False):
        since = counters()
        xg = x.clone().requires_grad_()
        sol = model.solve(xg)
        loss = ce_loss(sol.ys[-1], y).mean()
        fwd = launched(since, K1_K3)
        (dx,) = torch.autograd.grad(loss, xg, retain_graph=retain)
        torch.cuda.synchronize()
        return sol, (xg, loss), dx, fwd

    branches_k, branches_p = [], []
    since = counters()
    with groupsort_branches(model, branches_k):
        sol_k, (xg, loss_k), dx_k, fwd = loss_and_grad(retain=True)
    launches = launched(since, K1_K3)
    with plain_path(), groupsort_branches(model, branches_p):
        sol_p, (_, loss_p), dx_p, _ = loss_and_grad()
    flipped = torch.zeros(GRAD_BATCH, dtype=torch.bool, device=dev)
    for a, b in zip(branches_k, branches_p, strict=True):
        flipped |= (a != b).any(-1)
    n_flipped = int(flipped.sum())
    d_loss = abs(loss_k.item() - loss_p.item())
    scale = dx_p.abs().max().item()
    row_err = (dx_k - dx_p).abs().reshape(GRAD_BATCH, -1).amax(-1) / scale
    d_dx = row_err[~flipped].max().item()

    # one forward (the kernel path's), its backward by the plain VJPs
    with plain_backwards():
        (dx_shared,) = torch.autograd.grad(loss_k, xg)
    d_shared = ((dx_k - dx_shared).abs().max() / dx_shared.abs().max()).item()
    log(f"[9 grad] B={GRAD_BATCH} t_max={model.t_max}: kernel loss "
        f"{loss_k.item():.6f} nfe {sol_k.nfe} attempts {sol_k.attempts} | plain "
        f"loss {loss_p.item():.6f} nfe {sol_p.nfe} | |d loss|={d_loss:.3e} (tol "
        f"{GRAD_LOSS_TOL:g}) | max|dx|={scale:.3e}; max|d dx|/max|dx| on the "
        f"{GRAD_BATCH - n_flipped} images with no GroupSort flip {d_dx:.3e}, "
        f"over all {row_err.max().item():.3e} ({n_flipped} flipped) | shared "
        f"forward, kernel vs plain backward: {d_shared:.3e} (tol {GRAD_DX_TOL:g}) "
        f"| launches forward {fwd}, forward+backward {launches}")
    if not torch.isfinite(dx_k).all() or not scale > 0:
        raise RuntimeError("gradient through the solve is non-finite or zero")
    if not (d_loss <= GRAD_LOSS_TOL and d_dx <= GRAD_DX_TOL
            and d_shared <= GRAD_DX_TOL):
        raise RuntimeError(f"kernel-path gradient disagrees: {d_loss} {d_dx} "
                           f"{d_shared}")
    if n_flipped > GRAD_MAX_FLIPPED * GRAD_BATCH:
        raise RuntimeError(f"{n_flipped} images took another GroupSort branch "
                           "on the kernel path")
    if sol_k.nfe != sol_p.nfe:
        raise RuntimeError(f"NFE differs: kernel {sol_k.nfe} plain {sol_p.nfe}")
    if sol_k.attempts >= model.max_steps:
        raise RuntimeError("the solve used its whole step budget")
    want = {"k1.launches": sol_k.nfe, "k2.launches": sol_k.nfe,
            "k3.launches": 2 * len(CONV_SHAPES)}
    if launches != want or fwd["k3.launches"] != len(CONV_SHAPES):
        raise RuntimeError(f"launches {launches} (forward {fwd}), want {want}")

    ms = {"kernel": [], "plain": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        ctx = plain_path() if which == "plain" else contextlib.nullcontext()
        with ctx:
            t0 = time.perf_counter()
            loss_and_grad()
            ms[which].append(1e3 * (time.perf_counter() - t0))
    log(f"[9 time] loss + d/dx B={GRAD_BATCH}: kernel {min(ms['kernel']):.1f} ms "
        f"| plain {min(ms['plain']):.1f} ms (runs {ms})")
    return {"launches": launches}


def flagship_grad_phase(model, dev) -> dict:
    """[9 flagship grad] d(mean CE)/dx through the flagship's solve
    (scale_nominal on, t_max 1): K2 launched once per differentiated RHS
    evaluation, and the kernel backward against the plain backward on one
    shared forward."""
    from fiode_tpu_torch.attacks.apgd import ce_loss
    model.requires_grad_(False)
    x = torch.rand(GRAD_BATCH, 3, 32, 32, generator=gen(61)).to(dev)
    with torch.no_grad():
        y = model.predict(x).argmax(-1)
    xg = x.clone().requires_grad_()
    since = counters()
    sol = model.solve(xg)
    loss = ce_loss(sol.ys[-1], y).mean()
    fwd = launched(since)
    (dx_k,) = torch.autograd.grad(loss, xg, retain_graph=True)
    torch.cuda.synchronize()
    launches = launched(since)
    with plain_backwards():
        (dx_p,) = torch.autograd.grad(loss, xg)
    scale = dx_p.abs().max().item()
    d_shared = ((dx_k - dx_p).abs().max() / scale).item()
    k2 = launches["k2.launches"]
    log(f"[9 flagship grad] B={GRAD_BATCH} t_max={model.t_max} scale_nominal="
        f"{model.dynamics.scale_nominal}: loss {loss.item():.6f} nfe {sol.nfe} "
        f"accepted {sol.n_accepted} rejected {sol.n_rejected} | K2 launches "
        f"{k2} | max|dx|={scale:.3e}; shared forward, kernel vs plain "
        f"backward: {d_shared:.3e} (tol {GRAD_DX_TOL:g}) | launches forward "
        f"{fwd}, forward+backward {launches}")
    if not torch.isfinite(dx_k).all() or not scale > 0:
        raise RuntimeError("flagship gradient is non-finite or zero")
    if not d_shared <= GRAD_DX_TOL:
        raise RuntimeError(f"flagship kernel backward disagrees: {d_shared}")
    if sol.attempts >= model.max_steps:
        raise RuntimeError("the solve used its whole step budget")
    # every evaluation is differentiated unless a rejected step's are not
    if not (k2 == sol.nfe if sol.n_rejected == 0 else 0 < k2 <= sol.nfe):
        raise RuntimeError(f"K2 launched {k2} times for NFE {sol.nfe}")
    if launches["k3.launches"] != 2 * len(CONV_SHAPES):
        raise RuntimeError(f"K3 launches {launches}")
    return {"launches": launches}


def attack_phase(dev, n_iter=ATTACK_ITERS,
                 square_queries=SQUARE_QUERIES) -> dict:
    """[10 attack] run_autoattack with the standard suite on the trained
    checkpoint (best_torch.npz at the artifact's t_max 0.1, max_steps 8) and
    the 512 synthetic test images, held to the
    certificate: a validated adversarial on a certified image (every image
    but the refinement's open ones) fails the run.  Then APGD-CE alone on
    the kernel path and on the plain path."""
    from fiode_tpu_torch.attacks.apgd import apgd_ce
    from fiode_tpu_torch.entry import certify_model
    from fiode_tpu_torch.experiment import BudgetedForward, run_autoattack
    from fiode_tpu_torch.train.data import load_dataset
    model = certify_model(t_max=T_MAX, max_steps=MAX_STEPS, device=dev,
                          checkpoint=CERT_DIR / "ckpt" / "best_torch.npz")
    model.requires_grad_(False)
    ds = load_dataset("CIFAR10", str(ROOT / "data"))
    if not ds.synthetic or len(ds.test_x) != ATTACK_IMAGES:
        raise RuntimeError("phase 10 runs on the 512-image synthetic test set")
    x = torch.from_numpy(ds.test_x).to(dev)
    y = torch.from_numpy(ds.test_y).to(dev, torch.long)
    accounting = json.loads((CERT_DIR / "refine_accounting.json").read_text())
    open_images = set(accounting["open_images"])
    certified = torch.tensor([i not in open_images for i in range(ATTACK_IMAGES)],
                             device=dev)
    artifact = json.loads((CERT_DIR / "autoattack_full_standard_512_tmax01.json")
                          .read_text())
    since = counters()
    summary, x_adv = run_autoattack(
        model, x, y, eps=ATTACK_EPS, norm="L2", n_iter=n_iter,
        square_queries=square_queries, batch_size=ATTACK_IMAGES, seed=SEED)
    torch.cuda.synchronize()
    launches = launched(since, K1_K3)
    robust = torch.zeros(ATTACK_IMAGES, dtype=torch.bool, device=dev)
    robust[summary["robust_idx"]] = True
    dist = torch.linalg.norm((x_adv - x).reshape(ATTACK_IMAGES, -1), dim=-1)
    with torch.no_grad():
        out = model.predict(x_adv)
    pred = out.argmax(-1)
    true = out.gather(-1, y[:, None])[:, 0]
    margin = true - out.scatter(-1, y[:, None], -math.inf).amax(-1)
    for name, sec in summary["attack_seconds"].items():
        log(f"[10 attack] {name}: {sec:.2f} s, {ATTACK_IMAGES / sec:.2f} images/s")
    log(f"[10 attack] best_torch.npz t_max={model.t_max}: {summary['attacks']} "
        f"n_iter={n_iter} square_queries={square_queries} eps={ATTACK_EPS} on "
        f"synthetic test images 0-{ATTACK_IMAGES - 1}: robust "
        f"{len(summary['robust_idx'])}/{ATTACK_IMAGES} (JAX artifact "
        f"{len(artifact['robust_idx'])}/{artifact['n_images']}; certified "
        f"{int(certified.sum())}) in {summary['seconds']:.1f} s "
        f"({summary['images_per_sec']:.3f} images/s) | max attempts "
        f"{summary['max_attempts']} of max_steps {model.max_steps} (probe "
        f"{summary['probe_attempts']}), {summary['forwards']} forwards | "
        f"max L2 {dist.max().item():.5f} | launches {launches}")
    for i in (~robust).nonzero()[:, 0].tolist():
        log(f"[10 attack] adversarial on image {i} ({'certified' if certified[i] else 'open'}): "
            f"L2 {dist[i].item():.5f}, margin {margin[i].item():.3e}")
    if not torch.isfinite(x_adv).all():
        raise RuntimeError("a returned adversarial is non-finite")
    if not (dist.max() <= ATTACK_EPS * (1 + 1e-5) and x_adv.min() >= 0
            and x_adv.max() <= 1):
        raise RuntimeError("a returned adversarial left the ball or the box")
    if not (pred[~robust] != y[~robust]).all():
        raise RuntimeError("a validated success is not misclassified")
    if not (dist[robust] == 0).all():
        raise RuntimeError("a robust image was modified")
    if (certified & ~robust).any():
        raise RuntimeError("an adversarial was validated on a certified image: "
                           f"{(certified & ~robust).nonzero()[:, 0].tolist()}")
    if summary["max_attempts"] >= model.max_steps:
        raise RuntimeError("an attack forward reached max_steps")
    if min(launches.values()) == 0:
        raise RuntimeError(f"a kernel was not launched by the attacks: {launches}")

    ms = {"kernel": [], "plain": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        ctx = plain_path() if which == "plain" else contextlib.nullcontext()
        with ctx:
            g = torch.Generator(device=dev).manual_seed(SEED)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            apgd_ce(BudgetedForward(model), x, y, eps=ATTACK_EPS, norm="L2",
                    n_iter=n_iter, generator=g)
            torch.cuda.synchronize()
            ms[which].append(time.perf_counter() - t0)
    log(f"[10 time] apgd-ce alone n_iter={n_iter} B={ATTACK_IMAGES}: kernel "
        f"{min(ms['kernel']):.2f} s | plain {min(ms['plain']):.2f} s (runs "
        f"{ {k: [round(v, 2) for v in vs] for k, vs in ms.items()} })")
    return {"launches": launches}


def cert_rows(cert, feats, labels, eta):
    """One chunk's rows as Certifier.crown_block makes them."""
    from fiode_tpu_torch.verify.certify import label_perms
    perms = label_perms(labels, cert.n)
    I, (C, n) = len(labels), eta.shape
    x_biases = feats @ cert.U.T + cert.bU
    eta_l = cert.swap_columns(eta, perms).reshape(I * C, n)
    x_rows = x_biases[:, None, :].expand(I, C, -1).reshape(I * C, -1)
    label_rows = labels[:, None].expand(I, C).reshape(I * C)
    return x_biases, perms, eta_l, x_rows, label_rows


def grid_phase(dev):
    """[11 grid and checkpoint] the native enumeration at n = 10, T = 40, the
    trained checkpoint, and its clean accuracy on the synthetic test set."""
    from fiode_tpu_torch.entry import certify_model
    from fiode_tpu_torch.train.data import load_dataset
    from fiode_tpu_torch.verify.grid import (count_decision_boundary,
                                             enumerate_decision_boundary)
    t0 = time.perf_counter()
    count = count_decision_boundary(N_CLASSES, CERT_T)
    grid = enumerate_decision_boundary(N_CLASSES, CERT_T)
    enum_s = time.perf_counter() - t0
    g = torch.from_numpy(grid).to(dev)
    lattice = (g * CERT_T).round()
    sum_err = (g.sum(-1) - 1).abs().max().item()
    on_lattice = (g * CERT_T - lattice).abs().max().item()
    tied = bool((lattice[:, 0] == lattice[:, 1:].amax(-1)).all())
    sums = bool((lattice.sum(-1) == CERT_T).all())
    log(f"[11 grid] n={N_CLASSES} T={CERT_T}: {len(grid):,} cells (count "
        f"{count:,}) enumerated in {enum_s:.1f} s | max|sum - 1|={sum_err:.2e} "
        f"| lattice sums == T: {sums} | coordinate 0 ties the max: {tied}")
    if not (count == len(grid) == CERT_CELLS and sums and tied
            and sum_err <= 1e-6 and on_lattice <= 1e-4):
        raise RuntimeError("the decision-boundary grid is wrong")
    del g, lattice

    model = certify_model(t_max=CERT_T_MAX, max_steps=CERT_MAX_STEPS, device=dev,
                          checkpoint=CERT_DIR / "ckpt" / "best_torch.npz")
    ds = load_dataset("CIFAR10", str(ROOT / "data"))
    if not ds.synthetic or len(ds.test_x) != 512:
        raise RuntimeError("phases 11-13 run on the 512-image synthetic test set")
    x = torch.from_numpy(ds.test_x).to(dev)
    y = torch.from_numpy(ds.test_y).to(dev, torch.long)
    with torch.no_grad():
        sol = model.solve(x)
    clean = int((model.output_fn(sol.ys[-1]).argmax(-1) == y).sum())
    want = json.loads((CERT_DIR / "certify_stream_full_rep2.jsonl.json").read_text())
    log(f"[11 checkpoint] best_torch.npz on {len(x)} synthetic test images: clean "
        f"{clean}/{len(x)} (artifact {len(want['clean_idx'])}/{want['n_images']}) | "
        f"nfe {sol.nfe} attempts {sol.attempts} of max_steps {model.max_steps}")
    if clean != len(want["clean_idx"]) or clean != len(x):
        raise RuntimeError(f"clean accuracy {clean}/{len(x)} is not the artifact's")
    if sol.attempts >= model.max_steps:
        raise RuntimeError("the clean solve used its whole step budget")
    return model, grid, x, y


def k4_ptxas() -> tuple:
    """(registers, spill store bytes) ptxas reports for the flagship's K4,
    the most of its four variants."""
    from fiode_tpu_torch.ops._build import BUILD_DIR
    regs = spill = 0
    for p in BUILD_DIR.glob(f"libfused_crown-*-fiode_crown_n{N_CLASSES}-"
                            f"fiode_crown_m1{MLP}-fiode_crown_m2{MLP}-"
                            f"fiode_crown_out{N_CLASSES}.log"):
        text = p.read_text()
        regs = max([regs, *map(int, re.findall(r"Used (\d+) registers", text))])
        spill = max([spill, *map(int, re.findall(r"(\d+) bytes spill stores",
                                                 text))])
    return regs, spill


def crown_phase(model, grid, x, y, dev) -> dict:
    """[12 CROWN] the sweep on CROWN_IMAGES against the artifact's certified
    set; one block by stage."""
    from fiode_tpu_torch.verify.certify import (SUPERCHUNK, Certifier,
                                                float32_matmuls)
    from fiode_tpu_torch.ops.fused_crown import PASS, layer3_columns
    from fiode_tpu_torch.verify.crown import (_backward_from,
                                              crown_bounds_reference,
                                              crown_mlp_bounds,
                                              relu_relaxation)
    from fiode_tpu_torch.verify.ibp_qp import (ibp_cbf_qp,
                                               ibp_cbf_qp_band_reference,
                                               worst_case_vdot)
    cert = Certifier(model, T=CERT_T, eps_input=CERT_EPS, chunk=CERT_CHUNK,
                     grid=grid)
    want = json.loads((CERT_DIR / "certify_stream_full_rep2.jsonl.json").read_text())
    if abs(cert.kappa - want["kappa"]) > 1e-12 or want["T"] != CERT_T:
        raise RuntimeError(f"kappa {cert.kappa} is not the artifact's {want['kappa']}")
    idx = list(CROWN_IMAGES)
    xs, ys = x[idx[0]:idx[-1] + 1], y[idx[0]:idx[-1] + 1]

    # the sweep must run with TF32 off whatever the process says, and put
    # the process's setting back
    flags_inside = []
    block = cert.crown_block

    def spy(*args):
        flags_inside.append((torch.backends.cuda.matmul.allow_tf32,
                             torch.backends.cudnn.allow_tf32))
        return block(*args)

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    torch.cuda.reset_peak_memory_stats()
    since = counters()
    with mock.patch.object(cert, "crown_block", spy):
        res = cert.certify(xs, ys, method="crown")
    launches = launched(since)
    k4, k5 = launches["k4.launches"], launches["k5.launches"]
    restored = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    peak = torch.cuda.max_memory_allocated() / 2**30
    if set(flags_inside) != {(False, False)} or restored != (True, True):
        raise RuntimeError(f"TF32 inside the sweep {set(flags_inside)}, after it "
                           f"{restored}")
    got = [i for i, c in zip(idx, res.certified) if c]
    expect = [i for i in want["certified_idx"] if i in CROWN_IMAGES]
    for i, w, c in zip(idx, res.worst, res.certified):
        log(f"[12 crown] image {i} label {int(y[i])}: worst Vdot + kappa "
            f"{w:+.6f} -> {'certified' if c else 'not certified'} (artifact: "
            f"{'certified' if i in expect else 'not certified'})")
    rate = res.cells_checked / res.seconds
    log(f"[12 crown] images {idx[0]}-{idx[-1]}: clean {int(res.clean.sum())}/"
        f"{len(idx)}, certified {got} (artifact {expect}) | "
        f"{res.cells_checked:,} image-cells in {res.seconds:.1f} s, "
        f"{rate:,.0f} image-cells/s | peak device memory {peak:.2f} GiB | TF32 off "
        f"inside {len(flags_inside)} blocks, restored after | launches {launches}")
    if not res.clean.all() or got != expect:
        raise RuntimeError(f"CROWN certified {got}, the artifact {expect}")
    if res.cells_checked != len(idx) * CERT_CELLS:
        raise RuntimeError("the CROWN sweep did not cover the grid")
    if launches["k1.launches"] == 0 or launches["k3.launches"] != 2 * len(CONV_SHAPES):
        raise RuntimeError(f"the clean check's launches: {launches}")
    # K4: one launch a chunk, every chunk of the blocks (the last padded)
    chunks = -(-CERT_CELLS // CERT_CHUNK)
    swept = SUPERCHUNK * len(flags_inside)
    log(f"[12 crown] k4.launches {k4}, k5.launches {k5} over "
        f"{len(flags_inside)} blocks ({chunks} chunks of the grid, {swept} with "
        f"the last block's padding): the certified set above is K4's and K5's")
    if k4 != swept or swept != -(-chunks // SUPERCHUNK) * SUPERCHUNK:
        raise RuntimeError(f"K4 launched {k4} times for {swept} chunks")
    # K5: one launch a chunk too, the interval QP of every chunk
    if k5 != swept:
        raise RuntimeError(f"K5 launched {k5} times for {swept} chunks")

    # one chunk by stage (device time between events), then under the profiler
    with torch.no_grad(), float32_matmuls():
        feats = model.features(xs)
        eta = torch.from_numpy(grid[20 * CERT_CHUNK:21 * CERT_CHUNK]).to(dev)
        x_biases, perms, eta_l, x_rows, label_rows = cert_rows(cert, feats, ys, eta)
        a1, s1, a2 = cert.alpha_1, cert.sigma_1, cert.alpha_2
        lb, ub = crown_mlp_bounds(cert.Ws, cert.bs, eta_l, cert.eps, x_rows)
        f_lb, f_ub = ibp_cbf_qp(eta_l, cert.eps, lb, ub, a1, s1, a2)
        valid = torch.ones(1, CERT_CHUNK, dtype=torch.bool, device=dev)
        worst0 = torch.full((len(idx),), float("-inf"), device=dev)

        def chunk():
            return cert.crown_block(x_biases, ys, perms, eta[None], valid, worst0)

        since = counters()
        t_k4 = cuda_ms(lambda: crown_mlp_bounds(
            cert.Ws, cert.bs, eta_l, cert.eps, x_rows), 3, 1)
        k4_timed = launched(since)["k4.launches"]
        h_lb, h_ub = eta_l - cert.eps, eta_l + cert.eps
        since = counters()
        t_k5 = cuda_ms(lambda: ibp_cbf_qp(
            eta_l, cert.eps, lb, ub, a1, s1, a2), 3, 1)
        k5_timed = launched(since)["k5.launches"]
        t = {"crown": t_k4,
             "crown_plain": cuda_ms(lambda: crown_bounds_reference(
                 cert.Ws, cert.bs, eta_l, cert.eps, x_rows), 3, 1),
             "qp": t_k5,
             "qp_plain": cuda_ms(lambda: ibp_cbf_qp_band_reference(
                 h_lb, h_ub, lb, ub, a1, s1, a2), 3, 1),
             "vdot": cuda_ms(lambda: worst_case_vdot(
                 eta_l, cert.eps, f_lb, f_ub, label_rows), 3, 1),
             "chunk": cuda_ms(chunk, 3, 1)}
        ref = crown_bounds_reference(cert.Ws, cert.bs, eta_l, cert.eps, x_rows)
        scale = max(float(r.abs().max()) for r in ref)
        row_gap = torch.maximum(*((a - r).abs().amax(1)
                                  for a, r in zip((lb, ub), ref))) / scale
        k4_err, k4_off = float(row_gap.max()), int((row_gap > K4_TOL).sum())
        # what K4's lists hold on these rows, from the plain chain: layer 1's
        # neurons not off (layer 3's columns) and unstable ones, layer 2's
        l1, u1 = _backward_from(1, cert.Ws, cert.bs, [], eta_l, cert.eps, x_rows)
        l2, u2 = _backward_from(2, cert.Ws, cert.bs, [relu_relaxation(l1, u1)],
                                eta_l, cert.eps, x_rows)
        n1, n2 = layer3_columns(l1, u1), layer3_columns(l2, u2)
        us1, us2 = (((l < 0) & (u > 0)).sum(-1) for l, u in ((l1, u1), (l2, u2)))
        # a warp's rows take ceil(longer list / 16) columns a lane, PASS a pass
        cols = (torch.maximum(n1[0::2], n1[1::2]) + 15) // 16
        plan = {"live_share": float(n1.float().mean()) / MLP,
                "columns_per_lane": float(cols.float().mean()),
                "over_4_columns": float((cols > 4).float().mean()),
                "two_passes": float((cols > PASS).float().mean()),
                # the multiply-adds K4 does on them: layer 2's S and s
                # over the live list, D and d over the unstable one;
                # layer 3's two products and its . W1 over the live list
                "fma": float(((n1 + us1) * MLP * (N_CLASSES + 1)
                              + (n2 + us2) * N_CLASSES * n1
                              + 2 * N_CLASSES * (N_CLASSES + 1) * n1)
                             .double().sum())}
        qp_ref = ibp_cbf_qp_band_reference(h_lb, h_ub, lb, ub, a1, s1, a2)
        k5_err = max(float((g - r).abs().max()) for g, r in
                     zip((f_lb, f_ub), qp_ref)) / max(
                         float(r.abs().max()) for r in qp_ref)
        torch.cuda.reset_peak_memory_stats()
        wall, busy, top, top_ops = device_breakdown(chunk, top=6, top_ops=12)
        peak_chunk = torch.cuda.max_memory_allocated() / 2**30
    rows = len(idx) * CERT_CHUNK
    # K4's bound: CROWN's products counted dense, at the 3xTF32 rate (a
    # third of the TF32 peak) and on the fp32 cores; K4 skips the neurons
    # that add nothing, so it may beat the dense fp32 figure
    dense = rows * crown_flops(N_CLASSES, MLP)
    b3, b32 = 1e3 * dense / (TF32_FLOPS / 3), 1e3 * dense / FP32_FLOPS
    log(f"[12 K4] CROWN's bounds of one chunk ({rows} rows): K4 "
        f"{t['crown']:.3f} ms, {k4_timed} launches for its 4 calls (3 timed, "
        f"1 warm-up) | bound {b3:.3f} ms at the 3xTF32 rate "
        f"({100 * b3 / t['crown']:.1f}%), {b32:.3f} ms on the fp32 cores "
        f"({100 * b32 / t['crown']:.1f}%) for {dense / 1e9:.1f} GFLOP counted "
        f"dense | plain path {t['crown_plain']:.2f} ms "
        f"({t['crown_plain'] / t['crown']:.1f}x K4) | max gap to the plain "
        f"path {k4_err:.2e} of the bounds' largest, {k4_off} rows over "
        f"{K4_TOL:g} (a slope taken the other way at a tie u = -l)")
    b_lists = 1e3 * 2 * plan["fma"] / FP32_FLOPS
    regs, spill = k4_ptxas()
    log(f"[12 K4 lists] layer 3 ran over {100 * plan['live_share']:.1f}% of "
        f"layer 1's columns: {plan['columns_per_lane']:.2f} columns a lane of "
        f"{MLP // 16} on average, {100 * plan['over_4_columns']:.1f}% of the "
        f"warps more than 4, {100 * plan['two_passes']:.1f}% two passes | "
        f"the multiply-adds K4 does on them: {plan['fma'] / 1e9:.2f} G, "
        f"{b_lists:.3f} ms on the fp32 cores ({100 * b_lists / t['crown']:.1f}% "
        f"of K4's time) | ptxas: {regs} registers, {spill} bytes spilled")
    if k4_timed != 4:
        raise RuntimeError(f"K4 launched {k4_timed} times for 4 calls")
    if spill:
        raise RuntimeError(f"K4 spills {spill} bytes at the flagship's shape")
    if k4_off > K4_TIED_ROWS:
        raise RuntimeError(f"K4 parts from the plain path on {k4_off} rows")
    # K5's bound: 2 n projections of n lanes, 3 operations a lane and
    # halving (30: ibp_cbf_qp's, as crown_block calls it), at the float32
    # rate, or 6 n floats a row at the memory rate
    qp_ops = rows * 2 * N_CLASSES * 3 * N_CLASSES * 30
    b5 = 1e3 * max(qp_ops / FP32_FLOPS, rows * 24 * N_CLASSES / HBM_BYTES)
    log(f"[12 K5] the interval QP of one chunk ({rows} rows): K5 "
        f"{t['qp']:.4f} ms, {k5_timed} launches for its 4 calls | bound "
        f"{b5:.4f} ms ({100 * b5 / t['qp']:.1f}%) for {qp_ops / 1e9:.2f} G "
        f"operations | plain chain {t['qp_plain']:.2f} ms "
        f"({t['qp_plain'] / t['qp']:.0f}x K5) | max gap to the plain chain "
        f"{k5_err:.2e} of the bounds' largest")
    if k5_timed != 4:
        raise RuntimeError(f"K5 launched {k5_timed} times for 4 calls")
    if k5_err > K5_TOL:
        raise RuntimeError(f"K5 parts from the plain chain by {k5_err:.2e}")
    products = sum(ms for name, _, _, ms in top_ops
                   if name in ("aten::mm", "aten::bmm", "aten::addmm"))
    log(f"[12 device_breakdown] one chunk, {len(idx)} images x {CERT_CHUNK} cells = "
        f"{rows} rows: {t['chunk']:.2f} ms ({rows / t['chunk'] * 1e3:,.0f} "
        f"image-cells/s); its stages timed apart: CROWN bounds {t['crown']:.2f} "
        f"ms, interval QP {t['qp']:.2f} ms, worst-case Vdot {t['vdot']:.2f} ms "
        f"(sum {t['crown'] + t['qp'] + t['vdot']:.2f} ms) | under "
        f"torch.profiler: wall {wall:.1f} ms, device busy {busy:.1f} ms (idle share "
        f"{max(0.0, 1 - busy / wall):.2f}), products (mm, bmm) among the listed "
        f"operators {products:.2f} ms | peak device memory {peak_chunk:.2f} GiB")
    for name, ms in top:
        log(f"[12 device_breakdown]   kernel {ms:7.2f} ms  {name[:90]}")
    for name, shapes, calls, ms in top_ops:
        log(f"[12 device_breakdown]   op {ms:7.2f} ms  {calls:4d} x {name} {shapes[:100]}")

    return {"launches": launches, "rate": rate,
            "k4": {"launches": k4, "ms": t["crown"], "plain_ms": t["crown_plain"],
                   "bound_ms": b3, "bound_fp32_ms": b32, "max_rel_err": k4_err,
                   "bound_lists_ms": b_lists, "registers": regs,
                   "spill_bytes": spill, **plan},
            "k5": {"launches": k5, "ms": t["qp"], "plain_ms": t["qp_plain"],
                   "bound_ms": b5, "max_rel_err": k5_err}}


def lipschitz_phase(model, grid, x, y, dev) -> dict:
    """[13 Lipschitz / larger-T through K1] the sweep and exact_witness on
    LIPS_IMAGES against the artifacts; blocks through K1 against the same
    blocks through rhs_reference; K1's time at a block's rows."""
    from fiode_tpu_torch.ops.fused_rhs import fused_rhs, rhs_reference
    from fiode_tpu_torch.verify import certify as certify_module
    from fiode_tpu_torch.verify.certify import (Certifier, label_perms,
                                                float32_matmuls)
    cert = Certifier(model, T=CERT_T, eps_input=CERT_EPS, chunk=CERT_CHUNK,
                     grid=grid)
    want = json.loads((CERT_DIR / "lips_stream_full.jsonl.json").read_text())
    idx = list(LIPS_IMAGES)
    xs, ys = x[idx[0]:idx[-1] + 1], y[idx[0]:idx[-1] + 1]
    n_chunks = -(-CERT_CELLS // CERT_CHUNK)

    torch.cuda.reset_peak_memory_stats()
    since = counters()
    res = cert.certify(xs, ys, method="lipschitz")
    launches = launched(since)
    peak = torch.cuda.max_memory_allocated() / 2**30
    rate = res.cells_checked / res.seconds
    held_by_margin = []
    for name, verdicts, worst, expect in (
            ("lipschitz", res.certified, res.worst, want["certified_idx"]),
            ("larger-T", res.larger_T_certified, res.worst_larger_T,
             want["larger_T_certified_idx"])):
        got = [i for i, c in zip(idx, verdicts) if c]
        expect = [i for i in expect if i in LIPS_IMAGES]
        log(f"[13 {name}] images {idx[0]}-{idx[-1]}: certified {got} (artifact "
            f"{expect}) | worst " + " ".join(f"{w:+.4f}" for w in worst))
        for i, w in zip(idx, worst):
            if (i in got) != (i in expect):
                if abs(w) > CERT_MARGIN:
                    raise RuntimeError(f"{name}: image {i} (worst {w}) differs from "
                                       "the artifact")
                held_by_margin.append((name, i, float(w)))
    sweep_chunks = sweep_launches(n_chunks)
    log(f"[13 lipschitz] clean {int(res.clean.sum())}/{len(idx)} | "
        f"{res.cells_checked:,} image-cells in {res.seconds:.1f} s, {rate:,.0f} "
        f"image-cells/s | peak device memory {peak:.2f} GiB | launches {launches} "
        f"(K1: the clean solve's NFE + {sweep_chunks} chunks) | held by margin "
        f"(|worst| <= {CERT_MARGIN:g}): {held_by_margin}")
    if not res.clean.all() or res.cells_checked != len(idx) * CERT_CELLS:
        raise RuntimeError("the Lipschitz sweep did not cover the grid")
    if not sweep_chunks < launches["k1.launches"] <= sweep_chunks + 6 * CERT_MAX_STEPS + 2:
        raise RuntimeError(f"K1 launched {launches['k1.launches']} times for "
                           f"{sweep_chunks} chunks")

    # blocks through K1 and through rhs_reference: the first and the last
    # (padded) block of the grid
    with torch.no_grad(), float32_matmuls():
        feats = model.features(xs)
        perms = label_perms(ys, cert.n)
        p, xc_rows = cert.rhs_rows(feats, cert.chunk)
        blocks = list(cert.iter_blocks())
        block_err = 0.0
        for which in (0, len(blocks) - 1):
            etas, valids, n_valid = blocks[which]
            start = torch.full((len(idx),), float("-inf"), device=dev)
            since = counters()
            wk = cert.lips_block(p, xc_rows, ys, perms, etas, valids,
                                 (start, start.clone()))
            k1 = launched(since)["k1.launches"]
            with mock.patch.object(certify_module, "fused_rhs", rhs_reference):
                wp = cert.lips_block(p, xc_rows, ys, perms, etas, valids,
                                     (start, start.clone()))
            if launched(since)["k1.launches"] != k1 or k1 != etas.shape[0]:
                raise RuntimeError(f"K1 launches of one block: {k1}")
            err = max((a - b).abs().max().item() for a, b in zip(wk, wp))
            block_err = max(block_err, err)
            log(f"[13 K1 block] block {which} ({n_valid} valid cells of "
                f"{etas.shape[0] * etas.shape[1]}), {len(idx)} images: per-image "
                f"worst through K1 vs rhs_reference max|d|={err:.3e} (tol "
                f"{CERT_MARGIN:g}) | {k1} K1 launches")
            if not err <= CERT_MARGIN:
                raise RuntimeError(f"a block through K1 disagrees: {err}")
        etas, valids, _ = blocks[0]

        def one_block():
            start = torch.full((len(idx),), float("-inf"), device=dev)
            return cert.lips_block(p, xc_rows, ys, perms, etas, valids,
                                   (start, start.clone()))

        wall, busy, top, _ = device_breakdown(one_block, top=5)
        rows = len(idx) * CERT_CHUNK
        h = cert.swap_columns(etas[0], perms).reshape(rows, cert.n)
        args = (cert.alpha_1, cert.sigma_1, cert.alpha_2, False,
                model.dynamics.qp_iters)
        got, ref = fused_rhs(h, xc_rows, p, *args), rhs_reference(h, xc_rows, p, *args)
        k1_err = (got - ref).abs().max().item()
        k1_ms = kernel_ms(lambda: fused_rhs(h, xc_rows, p, *args), K1_KERNELS)
        k1_plain = cuda_ms(lambda: rhs_reference(h, xc_rows, p, *args), 5)
        k1_bound, k1_by = rhs_bound(rows, cert.n, MLP, model.dynamics.qp_iters)
    log(f"[13 device_breakdown] one block ({etas.shape[0]} chunks x {rows} rows): "
        f"wall {wall:.1f} ms, device busy {busy:.1f} ms (idle share "
        f"{max(0.0, 1 - busy / wall):.2f}); costliest: "
        + "; ".join(f"{name[:50]} {ms:.2f} ms" for name, ms in top))
    log(f"[13 time] K1 at a block's rows B={rows}: kernel {k1_ms:.4f} ms | plain "
        f"{k1_plain:.4f} ms | bound {k1_bound:.4f} ms ({k1_by}), "
        f"{100 * k1_bound / k1_ms:.1f}% of it | max|d| vs rhs_reference "
        f"{k1_err:.3e} (tol {K1_TOL:g})")
    if not k1_err <= K1_TOL:
        raise RuntimeError(f"K1 at a certification block's rows disagrees: {k1_err}")

    # exact_witness: the larger-T quantity with its argmax
    since = counters()
    t0 = time.perf_counter()
    vals, cells, clean = cert.exact_witness(xs, ys)
    wit_s = time.perf_counter() - t0
    wit_launches = launched(since)
    d_wit = float(abs(vals - res.worst_larger_T).max())
    log(f"[13 witness] exact_witness on images {idx[0]}-{idx[-1]} in {wit_s:.1f} s: "
        f"max|witness - larger-T worst|={d_wit:.3e} | launches {wit_launches}")
    if not (clean.all() and d_wit <= 1e-6):
        raise RuntimeError(f"exact_witness differs from the larger-T sweep: {d_wit}")
    # the committed witnesses: the same cell and the same verdict.  Their
    # values were taken with backbone features of another matmul precision
    # and differ from a float32 evaluation in the third decimal, so the
    # value's difference is printed, not gated.
    committed = json.loads((CERT_DIR / "exact_witnesses.json").read_text())
    for w in committed["witnesses"]:
        if w["image"] in LIPS_IMAGES:
            i = w["image"] - idx[0]
            verdict = "refuted" if vals[i] > 0 else "tractable"
            log(f"[13 witness] image {w['image']}: value {vals[i]:+.6f} at cell "
                f"{int(cells[i])}, {verdict} (artifact {w['witness_value']:+.6f} at "
                f"{w['witness_cell_idx']}, {w['verdict']})")
            if verdict != w["verdict"] or int(cells[i]) != w["witness_cell_idx"]:
                raise RuntimeError(f"witness of image {w['image']} differs")
    if wit_launches["k1.launches"] <= sweep_chunks:
        raise RuntimeError(f"exact_witness launched K1 {wit_launches['k1.launches']} times")
    return {"launches": launches, "rate": rate, "k1_block_err": max(block_err, k1_err),
            "res": res}


def sweep_launches(n_chunks: int) -> int:
    """Chunks a whole sweep launches: the grid's, rounded up to whole blocks."""
    from fiode_tpu_torch.verify.certify import SUPERCHUNK
    return -(-n_chunks // SUPERCHUNK) * SUPERCHUNK


def refine_phase(model, grid, x, y, dev, lips_res) -> dict:
    """[14 refine] CROWN BaB, hybrid BaB and Lipschitz BaB on the trained
    checkpoint at the committed passes' budgets, against their artifacts;
    one BaB round's device breakdown."""
    import numpy as np
    from fiode_tpu_torch.verify import refine as refine_module
    from fiode_tpu_torch.verify import refine_lips as refine_lips_module
    from fiode_tpu_torch.verify import refine_lips_uncertified, refine_uncertified
    from fiode_tpu_torch.verify.certify import SUPERCHUNK, Certifier, float32_matmuls
    t_phase = time.perf_counter()
    cert = Certifier(model, T=CERT_T, eps_input=CERT_EPS, chunk=CERT_CHUNK,
                     grid=grid)
    # a refinement sweep evaluates a block of chunk x SUPERCHUNK cells a call,
    # one K1 launch a block for the hybrid bound
    block = CERT_CHUNK * SUPERCHUNK
    sweep_blocks = -(-CERT_CELLS // block)
    labels = y.cpu().numpy()
    # each BaB's seconds and boxes, apart from the image's sweep
    bab_log = []
    real_bab = refine_module._bab

    def timed_bab(step_fn, img, centers, *args, **kw):
        t0 = time.perf_counter()
        out = real_bab(step_fn, img, centers, *args, **kw)
        bab_log.append({"seconds": time.perf_counter() - t0, "centers": centers,
                        "label": img.label})
        return out

    def run(fn, idx, **kw):
        bab_log.clear()
        with (mock.patch.object(refine_module, "_bab", timed_bab),
              mock.patch.object(refine_lips_module, "_bab", timed_bab)):
            t0 = time.perf_counter()
            new_cert, stats = fn(cert, x[list(idx)], labels[list(idx)], **kw)
            seconds = time.perf_counter() - t0
        babs = iter(list(bab_log))
        out = []
        for s in stats:
            bab = next(babs) if s.base_violated > 0 else None
            out.append((idx[s.image], s, bab))
        return new_cert, out, seconds

    since = counters()
    # 14a: plain CROWN BaB; the clean check runs inside (clean not given)
    artifact = {}
    for line in (CERT_DIR / "refine_full_pass5_stream.jsonl").read_text().splitlines():
        rec = json.loads(line)
        if rec["image"] in REFINE_IMAGES:
            artifact[rec["image"]] = rec
    _, crown_stats, crown_s = run(
        refine_uncertified, REFINE_IMAGES,
        certified=np.zeros(len(REFINE_IMAGES), bool), chunk=CERT_CHUNK,
        **REFINE_BUDGETS)
    launches_a = launched(since)
    # K4 and K5 bound each image's sweep, a launch each a call; the BaB steps
    # take the plain chains (their split dims are a gradient in the
    # half-widths, through CROWN and the QP)
    k4_a, k5_a = launches_a["k4.launches"], launches_a["k5.launches"]
    for i, s, bab in crown_stats:
        w, (f_viol, f_rounds, f_boxes) = artifact[i], REFINE_F32[i]
        bab_s = bab["seconds"] if bab else 0.0
        log(f"[14a crown BaB] image {i}: violated {s.base_violated} (float32 "
            f"{f_viol}, artifact {w['base_violated']}) | rounds {s.rounds} ({f_rounds}, "
            f"{w['rounds']}) | boxes {s.boxes_evaluated} ({f_boxes}, "
            f"{w['boxes_evaluated']}) | "
            f"{'certified' if s.certified else 'not certified: ' + s.gave_up} "
            f"(artifact {'certified' if w['certified'] else w['gave_up']}) | "
            f"{s.seconds:.1f} s: sweep {s.seconds - bab_s:.1f} s, BaB {bab_s:.3f} s "
            f"({s.boxes_evaluated / max(bab_s, 1e-9):,.0f} boxes/s)")
        if not s.certified:
            raise RuntimeError(f"CROWN BaB did not certify image {i}: {s}")
        if abs(s.base_violated - f_viol) > max(2, REFINE_VIOLATED_TOL * f_viol):
            raise RuntimeError(f"image {i}: {s.base_violated} violated cells, "
                               f"float32 {f_viol}")
        if s.rounds != f_rounds:
            raise RuntimeError(f"image {i}: {s.rounds} rounds, float32 {f_rounds}")
    log(f"[14a crown BaB] images {list(REFINE_IMAGES)}: {crown_s:.1f} s with the "
        f"clean check and feature pass | launches {launches_a} ("
        f"{k4_a / len(REFINE_IMAGES):.0f} K4 an image)")
    if k5_a != k4_a:
        raise RuntimeError(f"K5 launched {k5_a} times for K4's {k4_a} sweep calls")

    # one BaB round of image 221 (its violated cells) under the profiler
    with torch.no_grad(), float32_matmuls():
        centers = crown_stats[-1][2]["centers"]
        _, step_fn = refine_module._kernels(cert)
        i = REFINE_IMAGES[-1]
        img = refine_module._images(cert, x, [i])(0, labels[i])
        half = torch.full_like(centers, cert.eps)

        def one_round():
            return refine_module._evaluate(step_fn, centers, half, img, block)

        one_round()
        wall, busy, top, _ = device_breakdown(one_round, top=5)
    log(f"[14 device_breakdown] one BaB round of image {i}, {len(centers)} boxes "
        f"(one call, {block} rows at most): wall {wall:.1f} ms, device busy "
        f"{busy:.1f} ms (idle share {max(0.0, 1 - busy / wall):.2f}), "
        f"{len(centers) / wall * 1e3:,.0f} boxes/s; costliest: "
        + "; ".join(f"{name[:50]} {ms:.2f} ms" for name, ms in top))

    # 14b: the hybrid bound, K1 at every cell and box centre
    since = counters()
    _, hyb_stats, hyb_s = run(refine_uncertified, (HYBRID_IMAGE,),
                              certified=np.zeros(1, bool), clean=np.ones(1, bool),
                              chunk=CERT_CHUNK, **dict(REFINE_BUDGETS, lips_box=True))
    launches_b = launched(since)
    (_, s, bab), = hyb_stats
    bab_s = bab["seconds"] if bab else 0.0
    log(f"[14b hybrid BaB] image {HYBRID_IMAGE}: violated {s.base_violated} "
        f"(float32 {HYBRID_F32[0]}, worst {HYBRID_F32[1]:+.6f}; "
        f"hybrid_sweep_stream.jsonl {HYBRID_ARTIFACT[0]}, worst "
        f"{HYBRID_ARTIFACT[1]:+.6f}) | "
        f"rounds {s.rounds} | boxes {s.boxes_evaluated} | "
        f"{'certified' if s.certified else 'not certified: ' + s.gave_up} | "
        f"{hyb_s:.1f} s: BaB {bab_s:.3f} s | launches {launches_b} (K1: "
        f"{sweep_blocks} sweep blocks + one a BaB round's block)")
    if not s.certified or abs(s.base_violated - HYBRID_F32[0]) > 2:
        raise RuntimeError(f"hybrid BaB on image {HYBRID_IMAGE}: {s}")
    if not launches_b["k1.launches"] > sweep_blocks:
        raise RuntimeError(f"K1 ran on no BaB box: {launches_b['k1.launches']} launches "
                           f"for {sweep_blocks} sweep blocks")

    # 14c: the Lipschitz BaB, with phase 13's verdicts
    since = counters()
    lips_stats = []
    lips_s = 0.0
    for i in LIPS_REFINE_IMAGES:
        k = list(LIPS_IMAGES).index(i)
        rounds = LIPS_REFINE_ROUNDS if i == 3 else 60
        _, stats, secs = run(
            refine_lips_uncertified, (i,),
            certified=lips_res.certified[k:k + 1],
            exact_ok=lips_res.larger_T_certified[k:k + 1], clean=np.ones(1, bool),
            chunk=CERT_CHUNK, max_rounds=rounds, **LIPS_REFINE_BUDGETS)
        lips_stats += stats
        lips_s += secs
    launches_c = launched(since)
    for i, s, bab in lips_stats:
        bab_s = bab["seconds"] if bab else 0.0
        log(f"[14c lipschitz BaB] image {i}: violated {s.base_violated} | rounds "
            f"{s.rounds} | boxes {s.boxes_evaluated} | "
            f"{'certified' if s.certified else 'not certified: ' + s.gave_up} | "
            f"{s.seconds:.1f} s: BaB {bab_s:.2f} s "
            f"({s.boxes_evaluated / max(bab_s, 1e-9):,.0f} boxes/s)")
    by_image = {i: s for i, s, _ in lips_stats}
    s7, s3 = by_image[7], by_image[3]
    log(f"[14c lipschitz BaB] image 3: float32 {LIPS_REFINE_F32} violated cells; "
        f"artifact: image 7 collect_cap, image 3 {LIPS_REFINE_ARTIFACT} violated cells "
        f"(frontier_cap after 7 rounds there; {LIPS_REFINE_ROUNDS} rounds here) | "
        f"launches {launches_c}")
    if s7.gave_up != "collect_cap" or s7.certified:
        raise RuntimeError(f"image 7 did not give up with collect_cap: {s7}")
    if (abs(s3.base_violated - LIPS_REFINE_F32) > 1e-3 * LIPS_REFINE_F32
            or s3.certified or s3.gave_up != "rounds"):
        raise RuntimeError(f"image 3: {s3}")

    seconds = time.perf_counter() - t_phase
    launches = {k: launches_a[k] + launches_b[k] + launches_c[k] for k in launches_a}
    log(f"[14 refine] phase 14 in {seconds:.1f} s | launches {launches}")
    return {"launches": launches, "seconds": seconds, "crown_bab": launches_a}


def certify_phases(dev) -> dict:
    model, grid, x, y = grid_phase(dev)
    crown = crown_phase(model, grid, x, y, dev)
    lips = lipschitz_phase(model, grid, x, y, dev)
    refine = refine_phase(model, grid, x, y, dev, lips["res"])
    return {"crown": crown, "lipschitz": lips, "refine": refine}


# phase 15: Lyapunov certified training (configs/classification/*.yaml at
# full width on the synthetic sets; the only cuts are epochs and data)
TRAIN_EPOCHS = 2               # of cifar_train.yaml's 300
TRAIN_MNIST_SIZE = 704         # synthetic MNIST: 634 train (9 steps), 70 val
TRAIN_K3_PER_STEP = 7          # 4 forward, 3 on Q^H (layer 1's input needs no gradient)
# kernel step against plain step, from the same state and draws: each
# gradient within this share of its tensor's largest entry (the conv
# transforms' round-off, and near-tied GroupSort pairs that take the other
# branch), and each updated weight within this share of the learning rate
# (an Adam update is at most about lr)
TRAIN_GRAD_TOL, TRAIN_PARAM_TOL = 1e-3, 0.05
TRAIN_DIR = ROOT / "build" / "train_smoke"
K3_KERNELS = ("rdft", "mix_kernel")  # the names of K3's three launches


def _kernels_under(e, ranges: set) -> list:
    """(name, ms) of every kernel launched by event ``e`` or its children,
    less the device-side copies of the record_function ``ranges``."""
    out = [(k.name, k.duration / 1e3) for k in getattr(e, "kernels", [])
           if k.name not in ranges]
    for c in e.cpu_children:
        out += _kernels_under(c, ranges)
    return out


def _in_backward(e) -> bool:
    p = e.cpu_parent
    while p is not None:
        if p.name.startswith("autograd::engine::evaluate_function"):
            return True
        p = p.cpu_parent
    return False


def _dev_ms(e) -> float:
    us = getattr(e, "device_time_total", None)
    return (us if us is not None else getattr(e, "cuda_time_total", 0)) / 1e3


def train_step_breakdown(step) -> dict:
    """One call of ``step`` under torch.profiler: wall ms, device-busy ms,
    device events, and (device ms, kernels) by stage.  Forward stages are
    the trainer's spans (train.*, less the root train.step that holds them
    all), with the Cayley solves and K3 inside them listed again; the
    backward (autograd's own thread) is split by autograd node: the conv
    backward into K3 on Q^H and dQ (the dense-DFT VJP), the solves'
    backward, and the rest (the eval_dot, jvp / loss and linear layers'
    backward)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    stages: dict = {}

    def add(name, ks):
        ms, n = stages.get(name, (0.0, 0))
        stages[name] = (ms + sum(t for _, t in ks), n + len(ks))

    def k3(ks, keep=True):
        return [(k, t) for k, t in ks if any(x in k for x in K3_KERNELS) == keep]

    busy, n_kernels = 0.0, 0
    events = prof.events()
    ranges = range_names(events)
    for e in events:
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            if is_device_op(e, ranges):
                busy += e.time_range.elapsed_us() / 1e3
                n_kernels += 1
            continue
        if e.name.startswith("train.") and e.name != "train.step":
            ks = _kernels_under(e, ranges)
            add(e.name, ks)
            if e.name == "train.backbone":
                add("  of it K3 forward", k3(ks))
        elif e.name == "aten::linalg_solve" and not _in_backward(e):
            add("  of it cayley solves (forward)", _kernels_under(e, ranges))
        elif e.name.startswith("autograd::engine::evaluate_function: ") \
                and not _in_backward(e):
            node = e.name.split(": ", 1)[1]
            ks = _kernels_under(e, ranges)
            if "FusedFreqApply" in node:
                add("backward: K3 on Q^H", k3(ks))
                add("backward: dQ (dense-DFT VJP)", k3(ks, keep=False))
            elif "LinalgSolve" in node or "LinalgLu" in node:
                add("backward: cayley solves", ks)
            elif "FusedRhs" in node:
                add("backward: K2", ks)
            else:
                add("backward: rest (eval_dot, jvp / loss, linears)", ks)
    return {"wall_ms": wall, "busy_ms": busy, "idle": 1.0 - busy / wall,
            "kernels": n_kernels, "stages": stages}


def _snapshot(tr) -> dict:
    import copy
    return {"model": copy.deepcopy(tr.model.state_dict()),
            "opt": copy.deepcopy(tr.opt.state_dict()), "count": tr.opt_count,
            "gen": tr.gen.get_state(), "gen_adv": tr.gen_adv.get_state(),
            "lfx": copy.deepcopy(tr.lfx_state)}


def _restore(tr, snap) -> None:
    import copy
    tr.model.load_state_dict(snap["model"])
    tr.opt.load_state_dict(copy.deepcopy(snap["opt"]))
    tr.opt_count = snap["count"]
    tr.gen.set_state(snap["gen"])
    tr.gen_adv.set_state(snap["gen_adv"])
    tr.lfx_state = copy.deepcopy(snap["lfx"])


def _grads(model) -> dict:
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()
            if p.grad is not None}


def _params(model) -> dict:
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def _max_rel(a: dict, b: dict, floor: float = 0.0) -> tuple:
    """(largest |a - b| / max(max|b|, floor x the median tensor's max|b|)
    over the tensors, its name): a floor keeps a leaf whose gradient is
    round-off near zero from reading its round-off as a relative error
    (the benchmark's training check floors its gaps at the median leaf)."""
    from statistics import median
    scale = {n: b[n].abs().max().item() for n in b}
    low = floor * median(scale.values())
    return max(((a[n] - b[n]).abs().max().item()
                / max(scale[n], low, 1e-30), n) for n in b)


def train_phase(dev) -> dict:
    """[15 train] run_train on cifar_train.yaml at full width (KWLarge,
    mlp 128, B 128, S 256) on the synthetic CIFAR set for TRAIN_EPOCHS
    epochs (a); one Lyapunov step through the kernels against the plain
    path (b); two steps of the ode objective: K2 with weight gradients,
    against the plain backward, bit-stable (c); resume from epoch 1 (d);
    the best checkpoint through entry.certify_model (e); a few steps of
    mnist_train.yaml at full width, K3's direct passes (g); and the step's
    times."""
    import importlib.util
    import json as _json
    import shutil
    from fiode_tpu_torch.entry import certify_model
    from fiode_tpu_torch.experiment import build_trainer, run_train
    from fiode_tpu_torch.utils.config import compose
    t_phase = time.perf_counter()
    at_start = counters()
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    nodata = f"++data_root={TRAIN_DIR / 'no-data'}"
    cdir = str(ROOT / "configs" / "classification")
    has_yaml = importlib.util.find_spec("yaml") is not None
    cfg = compose("cifar_train.yaml", [nodata], config_dir=cdir)
    m = cfg["module"]
    B, S = cfg["batch_size"], m["h_sample_size"]
    log(f"[15 train] PyYAML {'is' if has_yaml else 'is not'} installed here; "
        f"configs read by the port's own reader | cifar_train.yaml: B={B} "
        f"S={S} rows/step={B * S} mlp={m['dynamics']['mlp_size']} "
        f"{m['init_fun']['param_map']['target']} {m['opt_name']} lr={m['lr']} "
        f"| cut: {TRAIN_EPOCHS} of {m['max_epochs']} epochs, synthetic data")

    # (a) run_train at full width
    since = counters()
    t0 = time.perf_counter()
    tr, test = run_train(cfg, run_dir=str(TRAIN_DIR / "a"), epochs=TRAIN_EPOCHS,
                         device=dev)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = launched(since)
    graph = launched(since, GRAPH_COUNTS)
    final = _params(tr.model)
    losses = torch.stack(tr.losses).cpu()
    steps = losses.numel()
    recs = [_json.loads(l) for l in open(TRAIN_DIR / "a" / "metrics.jsonl")]
    vals = [r for r in recs if "validation_error" in r and r["step"] >= 0]
    n_eval = TRAIN_EPOCHS * -(-len(tr.ds.val_x) // tr.cfg.val_batch_size) \
        + -(-len(tr.ds.test_x) // tr.cfg.val_batch_size)
    first, last = losses[0, :8].mean().item(), losses[-1, -8:].mean().item()
    log(f"[15a run_train] {steps} steps ({tr.steps_per_epoch}/epoch) + "
        f"{len(vals)} validations + test in {run_s:.1f} s | loss first 8 "
        f"{first:.5f} -> last 8 {last:.5f} | val_err "
        f"{[round(v['validation_error'], 4) for v in vals]} test_err "
        f"{test['validation_error']:.4f} val_nfe {[v['val_nfe'] for v in vals]} "
        f"| launches {launches} (K3 want {TRAIN_K3_PER_STEP} x {steps} + 4 x "
        f"{n_eval} solves) | CUDA graph: {graph['train.graph_captures']} "
        f"captures, {graph['train.graph_replays']} replays of {steps} steps")
    if not (torch.isfinite(losses).all() and all(
            math.isfinite(v["validation_loss"]) for v in vals)):
        raise RuntimeError("a training or validation loss is not finite")
    if not last < first:
        raise RuntimeError(f"the training loss did not fall: {first} -> {last}")
    if launches["k3.launches"] != TRAIN_K3_PER_STEP * steps + 4 * n_eval:
        raise RuntimeError(f"K3 launches {launches}")
    if launches["k1.launches"] == 0 or launches["k2.launches"] != 0:
        raise RuntimeError(f"K1 / K2 launches {launches}")
    phase_launches = dict(launches)

    # (b) one Lyapunov step, kernels against the plain path
    x = tr._train_x[:B]
    y = tr._train_y[:B]
    mixer = tr._epoch_mixer(TRAIN_EPOCHS - 1)
    sn = tr._phase_scale_nominal
    lr = tr._lr(tr.opt_count)
    snap = _snapshot(tr)
    since = counters()
    loss_k, _ = tr._train_step(x, y, steps, mixer, 0.0, sn)
    torch.cuda.synchronize()
    step_launches = launched(since, K1_K3)
    grads_k, params_k = _grads(tr.model), _params(tr.model)
    _restore(tr, snap)
    with plain_path():
        loss_p, _ = tr._train_step(x, y, steps, mixer, 0.0, sn)
    grads_p, params_p = _grads(tr.model), _params(tr.model)
    g_err, g_name = _max_rel(grads_k, grads_p)
    p_err = max((params_k[n] - params_p[n]).abs().max().item() for n in params_p)
    log(f"[15b step] Lyapunov step kernel vs plain: loss {loss_k.item():.6f} / "
        f"{loss_p.item():.6f} | max grad err {g_err:.3e} of its tensor's max "
        f"({g_name}; tol {TRAIN_GRAD_TOL:g}) | max |d param| {p_err:.3e} "
        f"(tol {TRAIN_PARAM_TOL:g} x lr {lr:.3e}) | launches per step "
        f"{step_launches}")
    if step_launches != {"k1.launches": 0, "k2.launches": 0,
                         "k3.launches": TRAIN_K3_PER_STEP}:
        raise RuntimeError(f"a Lyapunov step launched {step_launches}")
    if not (abs(loss_k.item() - loss_p.item()) <= 1e-4 * abs(loss_p.item())
            and g_err <= TRAIN_GRAD_TOL and p_err <= TRAIN_PARAM_TOL * lr):
        raise RuntimeError("the kernel step disagrees with the plain step")

    # timing: seconds per Lyapunov step (host, best of several), its
    # device time by stage, peak memory, validation seconds
    def lya_step():
        tr._train_step(x, y, steps, mixer, 0.0, sn)

    secs = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lya_step()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    lya_step()
    # what the step itself allocates above the state it starts from
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    bd = train_step_breakdown(lya_step)
    t0 = time.perf_counter()
    tr.evaluate()
    val_s = time.perf_counter() - t0
    log(f"[15 time] Lyapunov step: {1e3 * min(secs):.2f} ms best of "
        f"{len(secs)} (host clock; {[round(1e3 * s, 2) for s in secs]}) | "
        f"{B * S / min(secs):,.0f} rows/s | profiled: wall "
        f"{bd['wall_ms']:.2f} ms, device busy {bd['busy_ms']:.2f} ms in "
        f"{bd['kernels']} device events, idle {bd['idle']:.2f} (against the "
        f"best unprofiled step {1.0 - bd['busy_ms'] / (1e3 * min(secs)):.2f}) "
        f"| peak {peak:.2f} GiB above the step's start | validation "
        f"({len(tr.ds.val_x)} images) "
        f"{val_s:.2f} s")
    for name, (ms, n) in sorted(bd["stages"].items(), key=lambda kv: -kv[1][0]):
        log(f"    {name:48s} {ms:8.3f} ms  {n:5d} kernels")

    # (c) the ode objective: K2 with weight gradients
    ocfg = compose("cifar_train.yaml", [nodata, "++module.objective=ode"],
                   config_dir=cdir)
    otr = build_trainer(ocfg, str(TRAIN_DIR / "ode"), device=dev)
    otr.reset_optimizer(False)
    ox, oy = otr._train_x[:B], otr._train_y[:B]
    osn = otr._phase_scale_nominal
    since = counters()
    loss = otr._ode_ce_loss(ox, oy, osn)
    fwd = launched(since)
    otr.model.zero_grad(set_to_none=True)
    loss.backward(retain_graph=True)
    torch.cuda.synchronize()
    ode_launches = launched(since)
    g_kernel = _grads(otr.model)
    otr.model.zero_grad(set_to_none=True)
    with plain_backwards():
        loss.backward()
    g_plain = _grads(otr.model)
    og_err, og_name = _max_rel(g_kernel, g_plain)
    k1, k2 = fwd["k1.launches"], ode_launches["k2.launches"]
    snap = _snapshot(otr)
    runs, osecs = [], []
    for _ in range(2):
        _restore(otr, snap)
        for i in range(2):  # two steps from the same state
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            otr._train_step(ox, oy, i, otr._epoch_mixer(0), 0.0, osn)
            torch.cuda.synchronize()
            osecs.append(time.perf_counter() - t0)
        runs.append(_params(otr.model))
    bit = all(torch.equal(runs[0][n], runs[1][n]) for n in runs[0])
    log(f"[15c ode] B={B}: loss {loss.item():.6f} | K1 {k1} (NFE) K2 {k2} per "
        f"step | shared forward, kernel vs plain backward: max grad err "
        f"{og_err:.3e} of its tensor's max ({og_name}; tol {GRAD_DX_TOL:g}) | "
        f"two runs of 2 steps bit-identical: {bit} | ode step "
        f"{1e3 * min(osecs):.1f} ms best of {len(osecs)} (host clock)")
    if not (k1 > 0 and 0 < k2 <= k1
            and ode_launches["k3.launches"] == TRAIN_K3_PER_STEP):
        raise RuntimeError(f"ode step launches {ode_launches} (forward {fwd})")
    if not og_err <= GRAD_DX_TOL:
        raise RuntimeError(f"the ode step's kernel backward disagrees: {og_err}")
    if not bit:
        raise RuntimeError("two identical ode steps gave different weights")
    phase_launches["k2.launches"] += k2

    # (d) resume from epoch 1 of the same configuration
    run_train(cfg, run_dir=str(TRAIN_DIR / "d"), epochs=1, device=dev)
    tr_d, _ = run_train(cfg, run_dir=str(TRAIN_DIR / "d"), epochs=TRAIN_EPOCHS,
                        resume=True, device=dev)
    resumed = _params(tr_d.model)
    d_resume = max((resumed[n] - final[n]).abs().max().item() for n in final)
    log(f"[15d resume] resumed from epoch 1 vs uninterrupted: max |d param| "
        f"{d_resume:.3e} (gate: bit-equal)")
    if d_resume != 0.0:
        raise RuntimeError(f"the resumed run ended elsewhere: {d_resume}")

    # (e) the best checkpoint through certify_model
    best = _json.loads((tr.ckpt.dir / "best.json").read_text())
    cm = certify_model(checkpoint=tr.ckpt.path("best"), device=dev)
    # in the validation's batches: a solve takes its step control over its
    # whole batch, so other batches give other endpoints
    xv = torch.from_numpy(tr.ds.val_x).to(dev)
    with torch.no_grad():
        pred = torch.cat([cm.solve(xb, scale_nominal=sn).ys[-1].argmax(-1)
                          for xb in xv.split(tr.cfg.val_batch_size)])
    err = float((pred.cpu().numpy() != tr.ds.val_y).mean())
    log(f"[15e certify_model] best (step {best['step']}) loaded: error at "
        f"scale_nominal={sn} {err:.6f} in batches of "
        f"{tr.cfg.val_batch_size} vs the trainer's validation "
        f"{best['validation_error']:.6f}")
    if abs(err - best["validation_error"]) > 0.5 / len(pred):
        raise RuntimeError("certify_model does not reproduce the trained model")

    # (g) mnist_train.yaml at full width on a cut synthetic set (15f, the
    # trainer's other modes, is train_modes_phase)
    mcfg = compose("mnist_train.yaml", [nodata, f"++synthetic_size={TRAIN_MNIST_SIZE}"],
                   config_dir=cdir)
    since = counters()
    t0 = time.perf_counter()
    mtr, mtest = run_train(mcfg, run_dir=str(TRAIN_DIR / "mnist"), epochs=1,
                           device=dev)
    torch.cuda.synchronize()
    m_s = time.perf_counter() - t0
    mlaunch = launched(since)
    msteps = mtr.losses[0].numel()
    m_eval = -(-len(mtr.ds.val_x) // mtr.cfg.val_batch_size) \
        + -(-len(mtr.ds.test_x) // mtr.cfg.val_batch_size)
    log(f"[15g mnist] B={mcfg['batch_size']} S={mcfg['module']['h_sample_size']} "
        f"KWLargeMNIST (K3 at n = 28, 14, 7: direct passes), warmup optimizer: "
        f"{msteps} steps in {m_s:.1f} s, losses {mtr.losses[0].cpu().numpy().round(4).tolist()} "
        f"| test_err {mtest['validation_error']:.4f} | launches {mlaunch} | cut: "
        f"1 of 200 epochs, {len(mtr.ds.train_x)} synthetic train images")
    if not torch.isfinite(mtr.losses[0]).all():
        raise RuntimeError("an MNIST training loss is not finite")
    if mlaunch["k3.launches"] != TRAIN_K3_PER_STEP * msteps + 4 * m_eval:
        raise RuntimeError(f"MNIST K3 launches {mlaunch}")
    for k in phase_launches:
        phase_launches[k] += mlaunch[k]
    seconds = time.perf_counter() - t_phase
    graph = launched(at_start, GRAPH_COUNTS)
    log(f"[15 train] phase 15 in {seconds:.1f} s | launches {phase_launches} "
        f"| CUDA graph of the step: {graph['train.graph_captures']} captures, "
        f"{graph['train.graph_replays']} replays")
    return {"launches": phase_launches, "step_ms": 1e3 * min(secs)}

# phase 15f: the classifier trainer's other modes (adv_train, lips_train, the
# train_ode blend, val_adv) at cifar_train.yaml's full width on the synthetic
# CIFAR set.  Cut: MODE_STEPS steps of each mode from one state (and
# MODE_TIMED timed ones), one validation batch, and a run_train of one epoch
# on MODES_RUN_SIZE synthetic images.
MODES = {  # the TrainConfig fields each mode sets on cifar_train.yaml's
    "adv_train": {"adv_train": True},
    "lips_train": {"lips_train": True, "lips_warmup": 0},
    "train_ode": {"train_ode": True},
    "adv_train + lips_train": {"adv_train": True, "lips_train": True},
}
MODE_PORTION = 0.5             # the train_ode blend's ode_portion
MODE_STEPS, MODE_TIMED = 2, 3
PGD_TRAIN_ITERS, PGD_VAL_ITERS = 7, 5  # train/trainer.py's PGD-7 and PGD-5
MODES_RUN_SIZE = 1024
# the modes' gradient gate takes a leaf's gap over max(its max, this x the
# median leaf's max): a gradient the earlier modes' Adam steps left at
# round-off (4.4e-6 against a median of 6.1e-3, gap 3.5e-8) reads 5.8e-4,
# not 8.1e-3; a 1% fault in K2's weight gradients, K2's dh or K3 on Q^H
# still reads 1.0e-2 / 0.29 / 3.0e-2 (PERF.md section 7)
MODE_GRAD_FLOOR = 1e-2
# lips_train with a plain backbone: KWLarge's constant is 1 by construction,
# so the power iteration runs only on a backbone of LipsConv / LipsLinear
# layers (the reference's 4C3F at cifar_train.yaml's B, S and dynamics)
MODES_4C3F = "+module/init_fun/param_map@module.init_fun.param_map=CIFAR_4C3F"


def mode_k3_per_step(adv: bool, blend: bool) -> int:
    """K3 launches of one KWLarge training step, from the trainer's code: the
    loss's backbone forward and its backward on Q^H (TRAIN_K3_PER_STEP);
    the train_ode blend's solve runs the backbone once more; each PGD
    iteration of adv_train runs the forward and, the input now needing a
    gradient, K3 on Q^H in every conv layer."""
    k3 = TRAIN_K3_PER_STEP * (2 if blend else 1)
    return k3 + (PGD_TRAIN_ITERS * 2 * len(CONV_SHAPES) if adv else 0)


def train_modes_phase(dev) -> dict:
    """[15f modes] adv_train, lips_train, the train_ode blend and adv_train +
    lips_train on cifar_train.yaml (KWLarge, mlp 128, B 128, S 256), and
    lips_train on its 4C3F twin: MODE_STEPS steps of each from one state
    (loss, Lips and kappa finite), the first one's loss through the
    kernels against the plain path from the same state and draws, and its
    gradients by the kernels and by the plain VJPs on one shared forward
    (adv_train: on the kernel path's adversarial batch), the launches per
    step against mode_k3_per_step, host ms per step (best of MODE_TIMED),
    device busy and peak memory; val_adv's evaluate on one batch of 256
    with phase 15a's trained weights (train_phase runs first); run_train
    with adv_train, val_adv and lips_train for one epoch of MODES_RUN_SIZE
    images, whose best checkpoint follows validation_adv_error."""
    import dataclasses
    import json as _json
    import shutil
    from fiode_tpu_torch.attacks.pgd import pgd_attack
    from fiode_tpu_torch.bridge import load_npz
    from fiode_tpu_torch.experiment import build_trainer, run_train
    from fiode_tpu_torch.train import trainer as trainer_module
    from fiode_tpu_torch.train.lips import compute_lfx, lfx_init
    from fiode_tpu_torch.train.lyapunov import anneal_kappa, lips_kappa
    from fiode_tpu_torch.utils.config import compose
    t_phase = time.perf_counter()
    mdir = TRAIN_DIR / "modes"
    shutil.rmtree(mdir, ignore_errors=True)
    nodata = f"++data_root={TRAIN_DIR / 'no-data'}"
    cdir = str(ROOT / "configs" / "classification")
    phase_launches = dict.fromkeys(LAUNCHES, 0)

    def add(launches):
        for k in phase_launches:
            phase_launches[k] += launches[k]

    def run_mode(tr, name, fields, want_k3):
        """The mode's steps, checks and times on trainer ``tr``; launches
        want_k3 K3 a step."""
        base = tr.cfg
        cfg = tr.cfg = dataclasses.replace(base, **fields)
        B = cfg.batch_size
        x, y = tr._train_x[:B], tr._train_y[:B]
        mixer, sn = tr._epoch_mixer(0), tr._phase_scale_nominal
        portion = MODE_PORTION if cfg.train_ode else 0.0
        tr.reset_optimizer(False)
        tr.lfx_state = lfx_init(tr.model.backbone, tr.ds.image_shape,
                                torch.Generator(dev).manual_seed(cfg.seed + 1),
                                dev) if cfg.lips_train else None
        snap = _snapshot(tr)
        attacks = []  # the first step's adversarial batch on each path

        def recorded(*args, **kw):
            attacks.append(pgd_attack(*args, **kw))
            return attacks[-1]

        steps = []
        for i in range(MODE_STEPS):
            since = counters()
            with mock.patch.object(trainer_module, "pgd_attack",
                                   recorded if i == 0 else pgd_attack):
                loss, m = tr._train_step(x, y, i, mixer, portion, sn)
            torch.cuda.synchronize()
            if i == 0:
                launches, loss_k = launched(since), loss.item()
            steps.append((loss.item(), float(m["Lips"]), float(m["kappa"])))
        add(launches)
        if not all(math.isfinite(v) for step in steps for v in step):
            raise RuntimeError(f"{name}: a loss, Lips or kappa is not finite: {steps}")
        _restore(tr, snap)
        with plain_path(), mock.patch.object(trainer_module, "pgd_attack", recorded):
            loss_p = tr._train_step(x, y, 0, mixer, portion, sn)[0].item()
        # the step's loss through the kernels and through the plain path;
        # its gradients on one shared forward (the kernel path's, on its
        # adversarial batch), by the kernels and by the plain VJPs: a
        # near-tied GroupSort pair that takes the other branch on one path
        # (phase 9) moves that image's gradient, and its PGD, elsewhere, and
        # two adaptive solves round apart
        loss_tol = GRAD_LOSS_TOL if cfg.train_ode else 1e-4
        held = f"loss {loss_k:.6f} / {loss_p:.6f} (tol {loss_tol:g} rel)"
        if cfg.adv_train:
            d = (attacks[0] - attacks[1]).flatten(1).abs().amax(1)
            held = (f"PGD-{PGD_TRAIN_ITERS}'s batch max |d| {d.max().item():.3e}, "
                    f"{int((d > 1e-3).sum())} of {len(d)} images beyond 1e-3 | "
                    f"{held}")
        _restore(tr, snap)
        dyn = tr.model.dynamics
        if cfg.lips_train and tr.lfx_state is not None:
            Lfx = compute_lfx(tr.model.backbone, tr.lfx_state, tr.ds.image_shape)[0]
            kappa = lips_kappa(0, dyn.kappa, dyn.kappa_length, cfg.eps, Lfx,
                               cfg.lips_warmup)
        else:
            kappa = anneal_kappa(0, dyn.kappa, dyn.kappa_length)
        loss = tr._full_loss(attacks[0] if cfg.adv_train else x, y, mixer,
                             kappa, sn, portion, {})[0]
        tr.model.zero_grad(set_to_none=True)
        loss.backward(retain_graph=True)
        torch.cuda.synchronize()
        grads_k = _grads(tr.model)
        tr.model.zero_grad(set_to_none=True)
        with plain_backwards():
            loss.backward()
        grads_p = _grads(tr.model)
        g_err, g_name = _max_rel(grads_k, grads_p, floor=MODE_GRAD_FLOOR)
        own_err, own_name = _max_rel(grads_k, grads_p)
        g_tol = GRAD_DX_TOL if cfg.train_ode else TRAIN_GRAD_TOL
        held += (f" | shared forward, kernel vs plain backward: max grad err "
                 f"{g_err:.3e} ({g_name}; each leaf over max(its max, "
                 f"{MODE_GRAD_FLOOR:g} x the median leaf's); tol {g_tol:g}), "
                 f"over its own max alone {own_err:.3e} ({own_name})")
        ok = abs(loss_k - loss_p) <= loss_tol * abs(loss_p) and g_err <= g_tol
        # launches per step, derived from the code (mode_k3_per_step)
        solves = cfg.train_ode
        if not (launches["k3.launches"] == want_k3
                and (0 < launches["k2.launches"] <= launches["k1.launches"]
                     if solves else launches["k1.launches"] == 0
                     and launches["k2.launches"] == 0)):
            raise RuntimeError(f"{name}: launches per step {launches}, want K3 "
                               f"{want_k3} and K1 / K2 {'> 0' if solves else '0'}")
        _restore(tr, snap)
        secs = []
        for i in range(MODE_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr._train_step(x, y, i, mixer, portion, sn)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        base_mem = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        tr._train_step(x, y, 0, mixer, portion, sn)
        peak = (torch.cuda.max_memory_allocated() - base_mem) / 2 ** 30
        bd = train_step_breakdown(lambda: tr._train_step(x, y, 0, mixer, portion, sn))
        log(f"[15f {name}] steps (loss, Lips, kappa) "
            f"{[tuple(round(v, 5) for v in s) for s in steps]} | kernel vs plain: "
            f"{held} | launches per step {launches} (K3 want {want_k3}) | "
            f"{1e3 * min(secs):.2f} ms best of {len(secs)} (host clock; "
            f"{[round(1e3 * s, 2) for s in secs]}) | profiled in this process: "
            f"wall {bd['wall_ms']:.2f} ms, device busy {bd['busy_ms']:.2f} ms in "
            f"{bd['kernels']} device events, idle {bd['idle']:.2f} | peak "
            f"{peak:.2f} GiB above the step's start")
        if not ok:
            raise RuntimeError(f"{name}: the kernel step disagrees with the plain step")
        tr.cfg = base

    cfg = compose("cifar_train.yaml", [nodata], config_dir=cdir)
    tr = build_trainer(cfg, str(mdir / "steps"), device=dev)
    log(f"[15f modes] cifar_train.yaml: B={tr.cfg.batch_size} "
        f"S={tr.cfg.h_sample_size} eps={tr.cfg.eps:g} {tr.cfg.norm}, PGD-"
        f"{PGD_TRAIN_ITERS} in a step, PGD-{PGD_VAL_ITERS} at validation, "
        f"ode_portion {MODE_PORTION} | cut: {MODE_STEPS} steps a mode (+"
        f"{MODE_TIMED} timed), one validation batch, run_train 1 epoch of "
        f"{MODES_RUN_SIZE} images")
    for name, fields in MODES.items():
        run_mode(tr, name, fields, mode_k3_per_step(
            fields.get("adv_train", False), fields.get("train_ode", False)))
    log(f"[15f lips_train] KWLarge is orthogonal: Lips is its constant 1 and "
        f"no power iteration runs (lfx_state None), so the step is the "
        f"Lyapunov step")
    pcfg = compose("cifar_train.yaml", [nodata, MODES_4C3F,
                                        f"++synthetic_size={MODES_RUN_SIZE}"],
                   config_dir=cdir)
    ptr = build_trainer(pcfg, str(mdir / "4c3f"), device=dev)
    run_mode(ptr, "lips_train 4C3F", MODES["lips_train"], 0)

    # val_adv: evaluate on one validation batch, with the weights phase 15a
    # trained (at random weights ~96% of the images are wrong, many near a
    # tie, and the adversarial solve's other steps may right a few of them)
    trained = TRAIN_DIR / "a" / "ckpt" / "best.npz"
    load_npz(tr.model, trained)
    tr.cfg = dataclasses.replace(tr.cfg, val_adv=True)
    want_k3 = len(CONV_SHAPES) * (2 + 2 * PGD_VAL_ITERS)
    since = counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    val = tr.evaluate(max_batches=1)
    torch.cuda.synchronize()
    val_s = time.perf_counter() - t0
    launches = launched(since)
    add(launches)
    n_val = min(len(tr.ds.val_x), tr.cfg.val_batch_size)
    log(f"[15f val_adv] evaluate on {n_val} validation images ({trained}): error "
        f"{val['validation_error']:.4f}, adversarial {val['validation_adv_error']:.4f} "
        f"| {val_s:.2f} s | launches {launches} (K3 want {want_k3}: the clean "
        f"and adversarial solves and {PGD_VAL_ITERS} PGD forwards and backwards)")
    if not (launches["k3.launches"] == want_k3 and launches["k1.launches"] > 0
            and launches["k2.launches"] > 0):
        raise RuntimeError(f"val_adv launches {launches}")
    if not (math.isfinite(val["validation_loss"])
            and val["validation_adv_error"] >= val["validation_error"]):
        raise RuntimeError(f"val_adv: {val}")

    # the config runner reaches the modes
    rcfg = compose("cifar_train.yaml", [
        nodata, f"++synthetic_size={MODES_RUN_SIZE}", "++module.adv_train=true",
        "++module.val_adv=true", "++module.lips_train=true"], config_dir=cdir)
    since = counters()
    t0 = time.perf_counter()
    rtr, test = run_train(rcfg, run_dir=str(mdir / "run"), epochs=1, device=dev)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = launched(since)
    add(launches)
    losses = rtr.losses[0]
    best = _json.loads((rtr.ckpt.dir / "best.json").read_text())
    n_eval = sum(-(-len(xs) // rtr.cfg.val_batch_size)
                 for xs in (rtr.ds.val_x, rtr.ds.test_x))
    want_k3 = losses.numel() * mode_k3_per_step(True, False) + n_eval * (
        len(CONV_SHAPES) * (2 + 2 * PGD_VAL_ITERS))
    log(f"[15f run_train] adv_train + val_adv + lips_train, 1 epoch: "
        f"{losses.numel()} steps in {run_s:.1f} s, losses "
        f"{losses.cpu().numpy().round(4).tolist()} | best {best} (monitor "
        f"{rtr.ckpt.monitor}) | test error {test['validation_error']:.4f}, "
        f"adversarial {test['validation_adv_error']:.4f} | launches {launches} "
        f"(K3 want {want_k3})")
    if not (torch.isfinite(losses).all() and losses.numel() > 0):
        raise RuntimeError(f"run_train with the modes: losses {losses}")
    if not (rtr.ckpt.monitor == "validation_adv_error"
            and "validation_adv_error" in best
            and rtr.ckpt.path("best").exists()):
        raise RuntimeError(f"the best checkpoint does not follow "
                           f"validation_adv_error: {best}")
    if launches["k3.launches"] != want_k3:
        raise RuntimeError(f"run_train with the modes launched {launches}")
    seconds = time.perf_counter() - t_phase
    log(f"[15f modes] phase 15f in {seconds:.1f} s | launches {phase_launches}")
    return {"launches": phase_launches}


# phase 16: the Segway safe controller at examples/segway_workflow.py's
# protocol.  No TPU kernel is on this path (a 3 -> 32 -> 1 ReLU controller,
# an analytic plant, CROWN in plain PyTorch, the port's dopri5): K1-K3 must
# launch 0 times.  16a holds the port to the JAX package's float32 answers
# on the committed controller (tools/export_segway_reference.py)
SEGWAY_DIR = ROOT / "run_data" / "segway"
SEGWAY_RADII = ("0.01", "0.0025")  # not certified / certified in float32
SEGWAY_BAND_TOL, SEGWAY_VDOT_TOL, SEGWAY_SIM_TOL = 1e-6, 1e-4, 1e-4
SEGWAY_EDGE_ULPS = 2  # V this close to a band edge may fall either side
SEGWAY_LOSS_DROP = 0.01  # best barrier loss below this share of the first


def near_edge_cells(lya, edges, r, sizes) -> list:
    """The grid states whose V lies within SEGWAY_EDGE_ULPS float32 ulp of a
    band edge, as (state, V) pairs: two correct float32 evaluations of V
    may keep or drop them."""
    import numpy as np
    from fiode_tpu_torch.control.certify_segway import grid_slabs
    near = []
    for slab in grid_slabs(sizes, r, lya.P.device):
        v = lya(slab)[:, 0]
        for e in edges:
            e32 = np.float32(e)
            hit = (v - float(e32)).abs() <= SEGWAY_EDGE_ULPS * float(np.spacing(e32))
            near += list(zip(slab[hit].tolist(), v[hit].tolist()))
    return near


def control_step_profile(step) -> dict:
    """One call of ``step`` under torch.profiler: wall ms, device-busy ms,
    the number of kernels and the costliest ones."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    by_name: dict = {}
    events = prof.events()
    ranges = range_names(events)
    for e in events:
        if is_device_op(e, ranges):
            ms, n = by_name.get(e.name[:60], (0.0, 0))
            by_name[e.name[:60]] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    rows = sorted(((k, ms, n) for k, (ms, n) in by_name.items()), key=lambda r: -r[1])
    busy = sum(ms for _, ms, _ in rows)
    return {"wall_ms": wall, "busy_ms": busy, "kernels": sum(n for *_, n in rows),
            "top": rows[:6], "idle": 1.0 - busy / wall}


def segway_phase(dev, smi: str) -> dict:
    """[16 control] 16a: the port certifies the committed float32 reference
    controller at r = 0.01 and r = 0.0025 and simulates its five fixed
    starts, held to segway_f32.json; 16b: the port trains from seed 0 at the
    full protocol (300 LQR-fit iterations, 300 barrier iterations with the
    7-step Linf PGD at eps 0.02 over the r = 0.02 grid's 607,500 states),
    then certifies at r = 0.01 and simulates; 16c: the times."""
    import numpy as np
    from fiode_tpu_torch.control import (SegwayTrainConfig, certify_segway,
                                         load_segway, train_segway)
    from fiode_tpu_torch.control import systems as systems_module
    from fiode_tpu_torch.control.lyapunov_ctrl import LyaQuadratic
    from fiode_tpu_torch.control.samplers import grid_uniform_3d
    from fiode_tpu_torch.control.systems import Segway
    import importlib
    train_module = importlib.import_module("fiode_tpu_torch.control.train_segway")
    t_phase = time.perf_counter()
    ref = json.loads((SEGWAY_DIR / "segway_f32.json").read_text())
    sizes = (float(math.pi / 12), 1.5, 1.5)
    since = counters()

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # (a) parity on the committed controller
    model = load_segway(SEGWAY_DIR / "segway_f32.npz", dev)
    certify_segway(model=model, r=0.1, simulate_trajectories=False, verbose=False,
                   device=dev)  # warm-up: cuBLAS and the allocator
    cert_times = {}
    for r in SEGWAY_RADII:
        want = ref["certify"][r]
        got, secs = timed(lambda: certify_segway(
            model=model, r=float(r), simulate_trajectories=False, verbose=False,
            device=dev))
        cert_times[r] = (secs, got.n_cells)
        near = []
        if got.n_cells != want["n_cells"]:
            near = near_edge_cells(LyaQuadratic(model["P"], torch.zeros(1, 3, device=dev)),
                                   (got.level_lb, got.level_ub), float(r), sizes)
        band_err = max(abs(got.level_lb - want["level_lb"]),
                       abs(got.level_ub - want["level_ub"]))
        log(f"[16a parity] r={r}: cells {got.n_cells} (JAX float32 {want['n_cells']}; "
            f"grid states within {SEGWAY_EDGE_ULPS} ulp of a band edge: "
            f"{len(near) if near else 'not needed'}) | band [{got.level_lb:.8f}, "
            f"{got.level_ub:.8f}] (|d| {band_err:.2e}, tol {SEGWAY_BAND_TOL:g}) | ub_max "
            f"{got.ub_max:+.7f} (JAX {want['ub_max']:+.7f}) | exact_vdot_max "
            f"{got.exact_vdot_max:+.7f} (JAX {want['exact_vdot_max']:+.7f}) | certified "
            f"{got.certified} (JAX {want['certified']}) | {secs:.3f} s")
        for x, v in near[:20]:
            log(f"    near a band edge: x={x} V={v!r}")
        if abs(got.n_cells - want["n_cells"]) > len(near):
            raise RuntimeError(f"r={r}: {got.n_cells} cells against {want['n_cells']}, "
                               f"more than the {len(near)} states at a band edge")
        if not (band_err <= SEGWAY_BAND_TOL
                and abs(got.ub_max - want["ub_max"]) <= SEGWAY_VDOT_TOL
                and abs(got.exact_vdot_max - want["exact_vdot_max"]) <= SEGWAY_VDOT_TOL
                and got.certified == want["certified"]):
            raise RuntimeError(f"r={r}: the port's certificate disagrees with the "
                               f"JAX package's float32 answers: {got} vs {want}")
    if [ref["certify"][r]["certified"] for r in SEGWAY_RADII] != [False, True]:
        raise RuntimeError("segway_f32.json no longer holds the two verdicts")

    sim = ref["simulate"]
    sols = []

    def spy_odeint(*a, **k):
        sols.append(real_odeint(*a, **k))
        return sols[-1]

    real_odeint = systems_module.odeint
    with mock.patch.object(systems_module, "odeint", spy_odeint):
        (xs, _), sim_s = timed(lambda: Segway().simulate(
            torch.tensor(sim["x0"], device=dev), model["ctrl"], np.linspace(*sim["ts"]),
            rtol=sim["rtol"], atol=sim["atol"]))
    sol = sols[-1]
    end_err = float((xs[-1].cpu() - torch.tensor(sim["endpoint"])).abs().max())
    log(f"[16a parity] simulate {len(sim['x0'])} starts to t={sim['ts'][1]:g}: "
        f"endpoint max|d| {end_err:.2e} (tol {SEGWAY_SIM_TOL:g}) | steps "
        f"{sol.n_accepted}+{sol.n_rejected} rejected, NFE {sol.nfe} (JAX "
        f"{sim['n_accepted']}+{sim['n_rejected']}, NFE {sim['nfe']}) | {sim_s:.3f} s")
    if not end_err <= SEGWAY_SIM_TOL:
        raise RuntimeError(f"the simulated endpoints disagree with JAX's: {end_err}")

    # (b) the workload: train from seed 0 at the full protocol
    cfg = SegwayTrainConfig(adv_train=True, fit_lqr_iters=300, barrier_iters=300,
                            margin=0.01)
    fit, bar = [], []

    def spy(record, fn):
        def wrapped(*a, **k):
            out = fn(*a, **k)
            record.append((time.perf_counter(), out.detach()))
            return out
        return wrapped

    with mock.patch.object(train_module, "_fit_loss", spy(fit, train_module._fit_loss)), \
            mock.patch.object(train_module, "_barrier_loss",
                              spy(bar, train_module._barrier_loss)):
        res, train_s = timed(lambda: train_segway(cfg, verbose=False, device=dev))
    fit_l = torch.stack([l for _, l in fit]).cpu()
    bar_l = torch.stack([l for _, l in bar]).cpu()
    fit_it = (fit[-1][0] - fit[0][0]) / (len(fit) - 1)
    bar_it = (bar[-1][0] - bar[0][0]) / (len(bar) - 1)
    log(f"[16b train] seed {cfg.seed}: {len(fit)} LQR-fit + {len(bar)} barrier "
        f"iterations in {train_s:.2f} s | fit loss {fit_l[0]:.5f} -> {fit_l[-1]:.5f} | "
        f"barrier loss first {bar_l[0]:.3f} -> best {res['best_loss']:.5f} (JAX float32 "
        f"CPU: {ref['first_barrier_loss']} -> {ref['best_loss']:.5f})")
    if not (torch.isfinite(fit_l).all() and torch.isfinite(bar_l).all()):
        raise RuntimeError("a Segway training loss is not finite")
    if not res["best_loss"] < SEGWAY_LOSS_DROP * float(bar_l[0]):
        raise RuntimeError(f"the best barrier loss {res['best_loss']} is not below "
                           f"{SEGWAY_LOSS_DROP} of the first, {float(bar_l[0])}")
    sols.clear()
    with mock.patch.object(systems_module, "odeint", spy_odeint):
        mine, mine_s = timed(lambda: certify_segway(model=res, r=0.01, verbose=False,
                                                    device=dev))
    want = ref["certify"]["0.01"]
    log(f"[16b certify] r=0.01: cells {mine.n_cells} ub_max {mine.ub_max:+.5f} "
        f"exact_vdot_max {mine.exact_vdot_max:+.5f} certified {mine.certified} | "
        f"trajectory drift {mine.traj_max_level_drift} | JAX float32 on its own "
        f"controller: ub_max {want['ub_max']:+.5f} certified {want['certified']} | "
        f"{mine_s:.2f} s with the simulation ({sols[-1].nfe if sols else 0} NFE)")
    if not mine.exact_vdot_max < 0:
        raise RuntimeError(f"the port-trained controller has exact Vdot >= 0 in "
                           f"the band: {mine.exact_vdot_max}")

    # (c) times: one barrier step under the profiler, from the trained state
    ctrl = res["ctrl"]
    P = torch.nn.Parameter(res["P"].clone())
    opt = train_module._barrier_adam(ctrl, P, cfg)
    grid = torch.from_numpy(grid_uniform_3d(np.asarray(sizes, np.float32),
                                            np.full(3, cfg.grid_r))[0]).to(dev)
    gen = torch.Generator(dev).manual_seed(1)

    def barrier_step():
        with torch.no_grad():
            mask = train_module._band_mask(P, grid, cfg)
        eta = train_module._adversarial(ctrl, P, grid, mask, cfg, gen)
        loss = train_module._barrier_loss(ctrl, P, eta, mask, cfg)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return loss.item()

    barrier_step()
    prof = control_step_profile(barrier_step)
    for r, (secs, n) in cert_times.items():
        log(f"[16c times] certify r={r}: {secs:.3f} s, {n / secs:,.0f} cells/s | {smi}")
    log(f"[16c times] LQR fit {1e3 * fit_it:.3f} ms/iteration, barrier "
        f"{1e3 * bar_it:.3f} ms/iteration (host clock, {len(grid):,} grid states) | {smi}")
    log(f"[16c times] one barrier step: wall {prof['wall_ms']:.3f} ms, device busy "
        f"{prof['busy_ms']:.3f} ms, idle {prof['idle']:.3f}, {prof['kernels']} kernels; "
        f"top {[(k, round(ms, 3), c) for k, ms, c in prof['top']]} | {smi}")
    log(f"[16c times] simulate: {sim_s:.3f} s, {sol.n_accepted + sol.n_rejected} steps, "
        f"NFE {sol.nfe} | {smi}")
    launches = launched(since, K1_K3)
    if any(launches.values()):
        raise RuntimeError(f"a TPU kernel's port was launched on the Segway path: {launches}")
    log(f"[16 control] phase 16 in {time.perf_counter() - t_phase:.1f} s | launches "
        f"{launches} (no TPU kernel is on this path)")
    return {"launches": launches, "certified": bool(mine.certified)}


# phase 17: every solver, the continuous adjoint, the cached Cayley twin and
# the legacy conv dynamics
ODE_STEP = 0.1  # the fixed-grid methods' step
# two correct float32 solves (kernels against plain versions) may take
# different accept decisions only at a step whose error ratio both put
# this close to 1
RATIO_ROUNDING = 5e-2
ADJ_BATCH = 512
CACHED_TOL = 1e-6
# (B, C, H, W) of the legacy dynamics' input, its features, t_max, tolerance
LEGACY_SHAPE, LEGACY_FEATURES, LEGACY_T, LEGACY_TOL = (512, 3, 32, 32), 32, 0.5, 1e-4
# names of the Cayley transform's solve (torch.linalg.solve: LU factor and
# triangular solves) among the profiler's events
CAYLEY_SOLVE = ("linalg", "lu_factor", "getrf", "getrs", "trsm", "lu_solve")


def _add(total: dict, part: dict) -> None:
    for k, v in part.items():
        total[k] = total.get(k, 0) + v


def solver_phase(model, dev) -> dict:
    """[17a solvers] the flagship at B = TIME_BATCH with each adaptive and
    fixed-grid method, through the kernels (timed as the best of two) and
    through the plain path."""
    from fiode_tpu_torch.ode import integrate
    from fiode_tpu_torch.ode.tableaus import ADAPTIVE_SOLVERS, FIXED_SOLVERS
    real_ratio = integrate.rms_error_ratio
    x = torch.rand(TIME_BATCH, 3, 32, 32, generator=gen(80)).to(dev)
    with torch.no_grad():  # warm-up of both paths
        model.solve(x[:256])
        with plain_path():
            model.solve(x[:256])
    launches: dict = {}
    for method in ADAPTIVE_SOLVERS + FIXED_SOLVERS:
        fixed = method in FIXED_SOLVERS
        kw = {"method": method, "step_size": ODE_STEP if fixed else None}
        res = {}
        for which in ("plain", "kernel", "kernel"):
            ratios = []

            def spy(*a, **k):
                r = real_ratio(*a, **k)
                ratios.append(r)
                return r

            ctx = plain_path() if which == "plain" else contextlib.nullcontext()
            with torch.no_grad(), ctx, \
                    mock.patch.object(integrate, "rms_error_ratio", spy):
                since = counters()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                sol = model.solve(x, **kw)
                torch.cuda.synchronize()
                ms = 1e3 * (time.perf_counter() - t0)
                used = launched(since)
            if which in res:  # the repeat: its time only
                ms = min(ms, res[which][1])
            res[which] = (sol, ms, [r.item() for r in ratios], used)
        (sk, ms_k, rk, used), (sp, ms_p, rp, _) = res["kernel"], res["plain"]
        _add(launches, used)
        err = (sk.ys[-1] - sp.ys[-1]).abs().max().item()
        same = (sk.nfe, sk.n_accepted, sk.n_rejected) == (sp.nfe, sp.n_accepted,
                                                           sp.n_rejected)
        split = next((i for i, (a, b) in enumerate(zip(rk, rp))
                      if (a <= 1.0) != (b <= 1.0)), None)
        log(f"[17a {method}] B={TIME_BATCH}{f' step {ODE_STEP}' if fixed else ''}: "
            f"kernel nfe {sk.nfe} acc {sk.n_accepted} rej {sk.n_rejected} "
            f"{ms_k:.1f} ms | plain nfe {sp.nfe} acc {sp.n_accepted} rej "
            f"{sp.n_rejected} {ms_p:.1f} ms | max|d|={err:.3e} (tol {E2E_TOL:g})"
            + ("" if split is None else f" | first accept decision apart: step "
               f"{split}, ratios {rk[split]:.6f} / {rp[split]:.6f}")
            + f" | launches {used}")
        if not (torch.isfinite(sk.ys).all() and err <= E2E_TOL):
            raise RuntimeError(f"{method}: kernel path disagrees: {err}")
        if not fixed and max(sk.attempts, sp.attempts) >= model.max_steps:
            raise RuntimeError(f"{method}: a solve used its whole step budget")
        if not same and (fixed or split is None or not all(
                abs(r - 1.0) <= RATIO_ROUNDING for r in (rk[split], rp[split]))):
            raise RuntimeError(f"{method}: the step counts differ beyond the "
                               "rounding of the error ratio")
        if used["k1.launches"] != sk.nfe or used["k3.launches"] != len(CONV_SHAPES):
            raise RuntimeError(f"{method}: launches {used} for NFE {sk.nfe}")
    return {"launches": launches}


def adjoint_phase(flagship_model, dev) -> dict:
    """[17b adjoint] d(mean CE)/dx by the continuous adjoint (K1 + K2 in the
    augmented RHS, K2 without weight gradients) against the plain adjoint,
    for the trained certify configuration on the synthetic test images and
    the flagship, both at t_max 0.1 (the attack protocol's horizon), with
    phase 9's rule for GroupSort flips; the cosine to the discrete gradient.
    The flagship at its own t_max 1 is printed, not gated: there the
    backward solve cannot reconstruct y (its contracting dynamics expand
    backwards; the printed y(0) error), so two correct float32 adjoints
    part, as the JAX package's does from its own discrete gradient."""
    from fiode_tpu_torch.attacks.apgd import ce_loss
    from fiode_tpu_torch.entry import certify_model
    from fiode_tpu_torch.ode import adjoint as adjoint_module
    from fiode_tpu_torch.train.data import load_dataset
    trained = certify_model(t_max=T_MAX, max_steps=MAX_STEPS, device=dev,
                            checkpoint=CERT_DIR / "ckpt" / "best_torch.npz")
    ds = load_dataset("CIFAR10", str(ROOT / "data"))
    x_test = torch.from_numpy(ds.test_x[:ADJ_BATCH]).to(dev)
    x_rand = torch.rand(ADJ_BATCH, 3, 32, 32, generator=gen(61)).to(dev)
    cases = (("certify, trained", trained, x_test, T_MAX, True),
             ("flagship", flagship_model, x_rand, T_MAX, True),
             ("flagship", flagship_model, x_rand, 1.0, False))
    real_odeint = adjoint_module.odeint
    launches: dict = {}
    for name, model, x, t_max, gated in cases:
        model.requires_grad_(False)  # gradients in x only
        t_model = model.t_max
        model.t_max = t_max
        with torch.no_grad():
            y = model.predict(x).argmax(-1)

        def grad(use_adjoint, stats=None):
            xg = x.clone().requires_grad_()
            sol = model.solve(xg, use_adjoint=use_adjoint, adjoint_stats=stats)
            (dx,) = torch.autograd.grad(ce_loss(sol.ys[-1], y).mean(), xg)
            torch.cuda.synchronize()
            return sol, dx

        res = {}
        for which in ("plain", "kernel"):
            stats, branches, ends = {}, [], []

            def spy(*a, **k):
                sol = real_odeint(*a, **k)
                ends.append(sol.ys[-1])
                return sol

            ctx = plain_path() if which == "plain" else contextlib.nullcontext()
            with ctx, groupsort_branches(model, branches), \
                    mock.patch.object(adjoint_module, "odeint", spy):
                since = counters()
                t0 = time.perf_counter()
                sol, dx = grad(True, stats)
                ms = 1e3 * (time.perf_counter() - t0)
                used = launched(since, K1_K3)
            n = model.dynamics.n_hidden
            # the backward solve's y at t = 0 against h0, the simplex centre
            y0_err = (ends[-1][:ADJ_BATCH * n] - 1.0 / n).abs().max().item()
            res[which] = (sol, dx, stats, branches, ms, used, y0_err)
        (sk, dk, stk, bk, ms_k, used, y0_k), (sp, dp, stp, bp, ms_p, _, y0_p) = (
            res["kernel"], res["plain"])
        _add(launches, used)
        _, dd = grad(False)  # phase 9's discrete gradient, kernel path
        model.t_max = t_model
        flipped = torch.zeros(ADJ_BATCH, dtype=torch.bool, device=dev)
        for a, b in zip(bk, bp, strict=True):
            flipped |= (a != b).any(-1)
        n_flipped = int(flipped.sum())
        scale = dp.abs().max().item()
        row_err = (dk - dp).abs().reshape(ADJ_BATCH, -1).amax(-1) / scale
        d = row_err[~flipped].max().item()
        cos = torch.nn.functional.cosine_similarity(dk.flatten(), dd.flatten(),
                                                    dim=0).item()
        nb = stk["backward_nfe"]
        back_attempts = stk["backward_accepted"] + stk["backward_rejected"]
        log(f"[17b adjoint] {name} t_max {t_max} B={ADJ_BATCH}"
            f"{'' if gated else ' (printed, not gated)'}: forward nfe {sk.nfe}, "
            f"backward nfe {nb} acc {stk['backward_accepted']} rej "
            f"{stk['backward_rejected']} (plain {stp['backward_nfe']}) | kernel "
            f"{ms_k:.1f} ms, plain {ms_p:.1f} ms (forward + backward, host "
            f"clock) | max|dx|={scale:.3e}; max|d dx|/max|dx| on the "
            f"{ADJ_BATCH - n_flipped} images with no GroupSort flip {d:.3e} (tol "
            f"{GRAD_DX_TOL:g}), over all {row_err.max().item():.3e} ({n_flipped} "
            f"flipped) | cosine to the discrete gradient {cos:.6f} | backward "
            f"y(0) - h0: kernel {y0_k:.3e}, plain {y0_p:.3e} | launches {used}")
        if not torch.isfinite(dk).all() or not scale > 0:
            raise RuntimeError(f"{name}: the adjoint gradient is non-finite or zero")
        if gated and not d <= GRAD_DX_TOL:
            raise RuntimeError(f"{name}: the kernels' adjoint disagrees: {d}")
        if gated and n_flipped > GRAD_MAX_FLIPPED * ADJ_BATCH:
            raise RuntimeError(f"{name}: {n_flipped} images took another GroupSort branch")
        if max(sk.attempts, back_attempts) >= model.max_steps:
            raise RuntimeError(f"{name}: a solve used its whole step budget")
        want = {"k1.launches": sk.nfe + nb, "k2.launches": nb,
                "k3.launches": 2 * len(CONV_SHAPES)}
        if used != want:
            raise RuntimeError(f"{name}: launches {used}, want {want}")
    return {"launches": launches}


def profile_solve(fn) -> tuple:
    """fn() once under torch.profiler: (device-busy ms, the names of the
    events that belong to a Cayley transform's solve)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    busy, solves = 0.0, set()
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            us = getattr(e, "device_time_total", None)
            busy += (us if us is not None else getattr(e, "cuda_time_total", 0)) / 1e3
        if any(tag in e.key.lower() for tag in CAYLEY_SOLVE):
            solves.add(e.key)
    return busy, sorted(solves)


def cached_phase(dev) -> dict:
    """[17c cached twin] best_torch.npz's cached twin (Q of every Cayley
    layer computed once) against the model at B = TIME_BATCH; both solves
    timed between CUDA events and by the profiler's device-busy sum."""
    import copy
    from fiode_tpu_torch.entry import CIFAR_MU, CIFAR_STD, certify_model
    from fiode_tpu_torch.models.backbones import KWLargeBackbone
    from fiode_tpu_torch.models.layers import cache_cayley_params
    model = certify_model(t_max=CERT_T_MAX, max_steps=CERT_MAX_STEPS, device=dev,
                          checkpoint=CERT_DIR / "ckpt" / "best_torch.npz")
    twin = copy.deepcopy(model)
    twin.backbone = KWLargeBackbone(out_dim=N_CLASSES, act="GroupSort",
                                    mu=CIFAR_MU, std=CIFAR_STD,
                                    cached=True).to(dev)
    cache_cayley_params(twin, model)
    x = torch.rand(TIME_BATCH, 3, 32, 32, generator=gen(81)).to(dev)
    with torch.no_grad():
        since = counters()
        sol_u = model.solve(x)
        used_u = launched(since)
        since = counters()
        sol_c = twin.solve(x)
        used = launched(since)
        err = (model.output_fn(sol_c.ys[-1])
               - model.output_fn(sol_u.ys[-1])).abs().max().item()
        busy_u, _ = profile_solve(lambda: model.solve(x))
        busy_c, _ = profile_solve(lambda: twin.solve(x))
        # the same solves between CUDA events (device clock, idle gaps
        # included), in turns
        ms_u, ms_c = [], []
        for run, out in ((model, ms_u), (twin, ms_c), (twin, ms_c), (model, ms_u)):
            out.append(cuda_ms(lambda: run.solve(x), 1, warmup=0))
        # the backbone's forward (the dynamics are not cached: their densify
        # runs its four Cayley solves once per solve, in both)
        _, solves_u = profile_solve(lambda: model.backbone(x))
        _, solves_c = profile_solve(lambda: twin.backbone(x))
    log(f"[17c cached twin] best_torch.npz B={TIME_BATCH}: cached nfe {sol_c.nfe}, "
        f"uncached nfe {sol_u.nfe} | max|d prediction|={err:.3e} (tol "
        f"{CACHED_TOL:g}) | solve between CUDA events, best of 2: cached "
        f"{min(ms_c):.2f} ms, uncached {min(ms_u):.2f} ms | device busy per "
        f"solve (profiler): cached {busy_c:.2f} ms, uncached {busy_u:.2f} ms | "
        f"Cayley-solve events in the backbone's forward: cached {solves_c}, "
        f"uncached {len(solves_u)} ({', '.join(solves_u[:3])}, ...) | launches "
        f"cached {used}, uncached {used_u}")
    if not (torch.isfinite(sol_c.ys).all() and err <= CACHED_TOL
            and sol_c.nfe == sol_u.nfe):
        raise RuntimeError(f"the cached twin disagrees: {err}, nfe {sol_c.nfe} "
                           f"vs {sol_u.nfe}")
    if used["k3.launches"] != len(CONV_SHAPES):
        raise RuntimeError(f"the cached twin's forward launched K3 "
                           f"{used['k3.launches']} times")
    if solves_c or not solves_u:
        raise RuntimeError(f"the cached twin's forward ran a Cayley solve "
                           f"({solves_c}), or the check saw none in the "
                           f"model's ({solves_u})")
    used = {k: used[k] + used_u[k] for k in used}
    return {"launches": used}


def legacy_phase(dev) -> None:
    """[17d legacy dynamics] ConvBlockDynamics, basic and bottleneck, rk4
    step 0.1 to LEGACY_T on the card against the same module on the CPU."""
    import copy
    from fiode_tpu_torch.models.legacy_dynamics import ConvBlockDynamics
    from fiode_tpu_torch.ode.integrate import odeint
    x = torch.rand(*LEGACY_SHAPE, generator=gen(82))
    for block in ("basic", "bottleneck"):
        dyn = ConvBlockDynamics(features=LEGACY_FEATURES, block=block,
                                in_channels=LEGACY_SHAPE[1], generator=gen(83))
        sols, ms = {}, {}
        for where, d, xx in (("cuda", copy.deepcopy(dyn).to(dev), x.to(dev)),
                             ("cpu", dyn, x)):
            t0 = time.perf_counter()
            with torch.no_grad():
                sols[where] = odeint(lambda t, h: d(h, xx), d.state_init(xx),
                                     [0.0, LEGACY_T], method="rk4",
                                     step_size=ODE_STEP)
            if where == "cuda":
                torch.cuda.synchronize()
            ms[where] = 1e3 * (time.perf_counter() - t0)
        err = (sols["cuda"].ys.cpu() - sols["cpu"].ys).abs().max().item()
        log(f"[17d legacy] ConvBlockDynamics({LEGACY_FEATURES}, {block}) on "
            f"{LEGACY_SHAPE}, rk4 step {ODE_STEP} to t={LEGACY_T}: nfe "
            f"{sols['cuda'].nfe} | card {ms['cuda']:.1f} ms, CPU {ms['cpu']:.1f} "
            f"ms | max|card - CPU|={err:.3e} (tol {LEGACY_TOL:g})")
        if not (torch.isfinite(sols["cuda"].ys).all() and err <= LEGACY_TOL
                and sols["cuda"].nfe == sols["cpu"].nfe):
            raise RuntimeError(f"the legacy dynamics on the card disagree: {err}")


def ode_phases(model, dev) -> dict:
    """[17 solvers and adjoint] phases 17a-d; the kernels' launches."""
    t0 = time.perf_counter()
    launches: dict = {}
    _add(launches, solver_phase(model, dev)["launches"])
    _add(launches, adjoint_phase(model, dev)["launches"])
    _add(launches, cached_phase(dev)["launches"])
    torch.cuda.empty_cache()
    legacy_phase(dev)
    log(f"[17] phase 17 in {time.perf_counter() - t0:.1f} s | launches {launches}")
    return {"launches": launches}


# phase 18: the command line, python -m fiode_tpu_torch, in subprocesses on
# the card; its outputs go to build/cli_smoke/
CLI_DIR = ROOT / "build" / "cli_smoke"
CLI_CROWN_IMAGE = 4            # 18a: certified by the artifact
CLI_LIPS_IMAGES = range(0, 4)  # 18b
CLI_ATTACK_IMAGES = 64         # 18c
CLI_MESH_IMAGES = range(4, 6)  # 18g
CLI_MESH_CROWN_CELLS = 16 * 16 * CERT_CHUNK  # 18g's CROWN prefix of the grid
CLI_TIMEOUT = 600
# a module run as ``python -m <module>`` (runpy, as -m does; the module is
# the first argument), then the kernels' launches in that process, by their
# counters' names, as the last line of its stdout
CLI_COUNTING = (
    "import json, runpy, sys\n"
    "runpy.run_module(sys.argv.pop(1), run_name='__main__', alter_sys=True)\n"
    "from fiode_tpu_torch.utils.tracing import counters\n"
    f"print('LAUNCHES ' + json.dumps({{k: counters().get(k, 0) for k in {LAUNCHES!r}}}),"
    " flush=True)\n")


def run_cli(tag: str, args: list, counted: bool = True, launcher=None,
            module: str = "fiode_tpu_torch") -> dict:
    """One command of the CLI (or of another ``module``) in a subprocess
    from the repo root: its stdout and stderr, seconds and (``counted``) the
    kernels' launches in it.  A failing command fails the phase with its stderr
    printed."""
    cmd = ([sys.executable, "-c", CLI_COUNTING, module] if counted
           else [sys.executable, "-m", module]) + args
    if launcher:
        cmd = [sys.executable, "-m", *launcher, "-m", module, *args]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                              check=True, timeout=CLI_TIMEOUT)
    except subprocess.CalledProcessError as e:
        log(f"[{tag}] {' '.join(cmd[-len(args):])} failed:\n{e.stdout[-3000:]}\n"
            f"{e.stderr[-6000:]}")
        raise
    secs = time.perf_counter() - t0
    out = proc.stdout.splitlines()
    launches = None
    if counted:
        launches = json.loads(out[-1][len("LAUNCHES "):])
        out = out[:-1]
    for ln in [ln for ln in out if ln.strip()][-4:]:
        log(f"    {tag} | {ln[:200]}")
    return {"stdout": "\n".join(out), "stderr": proc.stderr, "seconds": secs,
            "launches": launches}


def cli_phase(dev) -> dict:
    """[18 cli] the port's command line on the card: 18a certify-crown of
    image 4 over the whole T = 40 grid and summarize-stream of its log;
    18b certify-lipschitz of images 0-3; 18c eval-autoattack (apgd-ce,
    apgd-t) of 64 images; 18d train cifar_train.yaml for one epoch, then
    certify-lipschitz restoring its best.npz; 18e the same training under
    torch.distributed.run on one NCCL rank; 18f segway-certify with figures;
    18g the Certifier on a mesh of the card, in this process.  The commands
    run at once (as phase 19's drivers do) while this process does 18b's
    sweep and 18g, then each is checked in turn: a command's seconds are
    its wall time among the others on the card."""
    import shutil
    t_phase = time.perf_counter()
    shutil.rmtree(CLI_DIR, ignore_errors=True)
    CLI_DIR.mkdir(parents=True)
    run_dir = str(CERT_DIR.relative_to(ROOT))
    certify_args = ["--config-name", "cifar_certify.yaml", "--run-dir", run_dir]
    secs, launches = {}, {}
    crown_log, lips_log = CLI_DIR / "crown.jsonl", CLI_DIR / "lips.jsonl"
    aa_out, plot_dir = CLI_DIR / "autoattack.json", CLI_DIR / "segway_plots"
    train_dir, ddp_dir = CLI_DIR / "train", CLI_DIR / "train_ddp"
    train_args = ["train", "--config-name", "cifar_train.yaml", "--epochs", "1"]
    lips_lo, lips_hi = CLI_LIPS_IMAGES[0], CLI_LIPS_IMAGES[-1] + 1

    def crown():  # 18a, then summarize-stream of its log
        return (run_cli("18a", ["certify-crown", *certify_args,
                                f"++start_ind={CLI_CROWN_IMAGE}",
                                f"++end_ind={CLI_CROWN_IMAGE + 1}",
                                "--stream-out", str(crown_log)]),
                run_cli("18a", ["summarize-stream", str(crown_log), "--out",
                                str(CLI_DIR / "crown_summary.json")],
                        counted=False))

    def train():  # 18d, then certify-lipschitz restoring its best.npz
        return (run_cli("18d", [*train_args, "--run-dir", str(train_dir)]),
                run_cli("18d", ["certify-lipschitz", "--config-name",
                                "cifar_certify.yaml", "--run-dir",
                                str(train_dir), "++end_ind=2", "--stream-out",
                                str(CLI_DIR / "train_lips.jsonl")]))

    pool = ThreadPoolExecutor(6)
    jobs = {
        "18a": pool.submit(crown),
        "18b": pool.submit(run_cli, "18b", [
            "certify-lipschitz", *certify_args, f"++start_ind={lips_lo}",
            f"++end_ind={lips_hi}", "--stream-out", str(lips_log)]),
        "18c": pool.submit(run_cli, "18c", [
            "eval-autoattack", *certify_args, "--max-images",
            str(CLI_ATTACK_IMAGES), "--attacks", "apgd-ce,apgd-t", "--out",
            str(aa_out), f"++module.t_max={T_MAX}",
            f"++module.max_steps={MAX_STEPS}"]),
        "18d": pool.submit(train),
        "18e": pool.submit(run_cli, "18e", [
            *train_args, "--multihost", "--run-dir", str(ddp_dir)],
            counted=False, launcher=["torch.distributed.run", "--standalone",
                                     "--nproc_per_node=1"]),
        "18f": pool.submit(run_cli, "18f", [
            "segway-certify", "--model",
            str((SEGWAY_DIR / "segway_f32.npz").relative_to(ROOT)), "--r",
            "0.01", "--plot-dir", str(plot_dir)], counted=False),
    }
    try:
        _cli_checks(dev, jobs, secs, launches)
    finally:
        pool.shutdown(wait=True)
    seconds = time.perf_counter() - t_phase
    log(f"[18 cli] phase 18 in {seconds:.1f} s | "
        + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items()))
    return {"launches": launches, "seconds": seconds}


def _cli_checks(dev, jobs, secs, launches) -> None:
    """Phase 18's checks of each command in ``jobs`` (futures of run_cli),
    in order, and 18b's and 18g's work in this process."""
    import importlib.util
    import numpy as np
    from fiode_tpu_torch.entry import certify_model
    from fiode_tpu_torch.parallel.mesh import Mesh
    from fiode_tpu_torch.train.data import load_dataset
    from fiode_tpu_torch.verify.certify import Certifier
    from fiode_tpu_torch.verify.grid import enumerate_decision_boundary
    crown_log, lips_log = CLI_DIR / "crown.jsonl", CLI_DIR / "lips.jsonl"
    aa_out, plot_dir = CLI_DIR / "autoattack.json", CLI_DIR / "segway_plots"
    train_dir, ddp_dir = CLI_DIR / "train", CLI_DIR / "train_ddp"

    # the in-process model, grid and images of 18b and 18g
    model = certify_model(t_max=CERT_T_MAX, max_steps=CERT_MAX_STEPS, device=dev,
                          checkpoint=CERT_DIR / "ckpt" / "best_torch.npz")
    ds = load_dataset("CIFAR10", str(ROOT / "data"))
    x = torch.from_numpy(ds.test_x).to(dev)
    y = torch.from_numpy(ds.test_y).to(dev, torch.long)
    grid = enumerate_decision_boundary(N_CLASSES, CERT_T)

    # 18b's sweep in this process, while the commands run
    lo, hi = CLI_LIPS_IMAGES[0], CLI_LIPS_IMAGES[-1] + 1
    mine = Certifier(model, T=CERT_T, eps_input=CERT_EPS, chunk=CERT_CHUNK,
                     grid=grid).certify(x[lo:hi], y[lo:hi], method="lipschitz")

    # 18g: the Certifier on a mesh of the card: a 1-D mesh [cuda:0, cuda:0]
    # over cells and a 1 x 1 ("img", "cell") mesh against the unsharded
    # sweep: Lipschitz over the whole grid, CROWN over its first
    # CLI_MESH_CROWN_CELLS cells
    t0 = time.perf_counter()
    lo, hi = CLI_MESH_IMAGES[0], CLI_MESH_IMAGES[-1] + 1
    meshes = {"none": None, "cell [cuda:0] x 2": Mesh([dev, dev], ("cell",)),
              "img x cell 1 x 1": Mesh([[dev]], ("img", "cell"))}
    for method, g in (("lipschitz", grid), ("crown", grid[:CLI_MESH_CROWN_CELLS])):
        res = {name: Certifier(model, T=CERT_T, eps_input=CERT_EPS, chunk=CERT_CHUNK,
                               grid=g, mesh=mesh).certify(x[lo:hi], y[lo:hi],
                                                          method=method,
                                                          early_exit=False)
               for name, mesh in meshes.items()}
        base = res["none"]
        for name, rr in res.items():
            d = float(np.abs(rr.worst - base.worst).max())
            same = (np.array_equal(rr.certified, base.certified)
                    and np.array_equal(rr.larger_T_certified, base.larger_T_certified)
                    and rr.cells_checked == base.cells_checked)
            log(f"[18g mesh] {method} images {lo}-{hi - 1} over {len(g):,} cells, "
                f"{name}: certified {rr.certified.tolist()} | worst "
                + " ".join(f"{w:+.6f}" for w in rr.worst)
                + f" | max|d worst| {d:.3e} | verdicts equal: {same}")
            if not same:
                raise RuntimeError(f"18g: {method} on {name} differs from the unsharded sweep")
    secs["18g"] = time.perf_counter() - t0

    # 18a: CROWN over the whole grid, then summarize-stream of its log
    r, rs = jobs["18a"].result()
    secs["18a"], launches["18a"] = r["seconds"], r["launches"]
    summary = json.loads(Path(f"{crown_log}.json").read_text())
    want = json.loads((CERT_DIR / "certify_stream_full_rep2.jsonl.json").read_text())
    expect = [i for i in want["certified_idx"] if i == CLI_CROWN_IMAGE]
    secs["18a summarize"] = rs["seconds"]
    folded = json.loads((CLI_DIR / "crown_summary.json").read_text())
    common = ("n_images", "matmul_precision", "clean_acc", "certified_acc",
              "certified_idx", "cells_checked")
    log(f"[18a certify-crown] image {CLI_CROWN_IMAGE}: clean {summary['clean_idx']} "
        f"certified {summary['certified_idx']} (artifact {expect}) | "
        f"{summary['cells_checked']:,} image-cells in {summary['seconds']:.1f} s | "
        f"command {secs['18a']:.1f} s | launches {launches['18a']} | "
        f"summarize-stream equal on {common}: "
        f"{all(folded[k] == summary[k] for k in common)}")
    if summary["clean_idx"] != [CLI_CROWN_IMAGE] or summary["certified_idx"] != expect:
        raise RuntimeError(f"18a: certified {summary['certified_idx']}, artifact {expect}")
    if summary["cells_checked"] != CERT_CELLS:
        raise RuntimeError("18a: the sweep did not cover the grid")
    if not (launches["18a"]["k1.launches"] and launches["18a"]["k3.launches"]):
        raise RuntimeError(f"18a: the clean check missed K1 or K3: {launches['18a']}")
    if any(folded[k] != summary[k] for k in common):
        raise RuntimeError(f"18a: summarize-stream {folded} differs from {summary}")

    # 18b: Lipschitz, held to the same sweep in this process and to the
    # artifact (an image whose worst value lies within CERT_MARGIN of zero
    # is held by its margin, as in phase 13)
    lo, hi = CLI_LIPS_IMAGES[0], CLI_LIPS_IMAGES[-1] + 1
    r = jobs["18b"].result()
    secs["18b"] = r["seconds"]
    got = json.loads(Path(f"{lips_log}.json").read_text())
    art = json.loads((CERT_DIR / "lips_stream_full.jsonl.json").read_text())
    for key, verdicts, worst in (
            ("certified_idx", mine.certified, mine.worst),
            ("larger_T_certified_idx", mine.larger_T_certified, mine.worst_larger_T)):
        here = [lo + i for i, c in enumerate(verdicts) if c]
        expect = [i for i in art[key] if lo <= i < hi]
        log(f"[18b certify-lipschitz] {key}: CLI {got[key]} | in process {here} | "
            f"artifact {expect} | worst " + " ".join(f"{w:+.4f}" for w in worst))
        if got[key] != here:
            raise RuntimeError(f"18b: the CLI's {key} {got[key]} is not {here}")
        for i, w in zip(range(lo, hi), worst):
            if (i in here) != (i in expect) and abs(w) > CERT_MARGIN:
                raise RuntimeError(f"18b: image {i} (worst {w}) differs from the artifact")
    log(f"[18b certify-lipschitz] command {secs['18b']:.1f} s")

    # 18c: attacks at the attack protocol's t_max 0.1, max_steps 8; no
    # certified image (every one but the open ones) may be broken
    r = jobs["18c"].result()
    secs["18c"], launches["18c"] = r["seconds"], r["launches"]
    aa = json.loads(aa_out.read_text())
    jax_fields = set(json.loads((CERT_DIR / "autoattack_full_standard_512_tmax01.json")
                                .read_text()))
    open_images = set(json.loads((CERT_DIR / "refine_accounting.json").read_text())
                      ["open_images"])
    broken = [i for i in range(CLI_ATTACK_IMAGES)
              if i not in aa["robust_idx"] and i not in open_images]
    log(f"[18c eval-autoattack] {aa['attacks']} on {aa['n_images']} images: robust "
        f"{len(aa['robust_idx'])}/{aa['n_images']} in {aa['seconds']:.1f} s, max "
        f"attempts {aa['max_attempts']} of {aa['max_steps']} | certified broken: "
        f"{broken} | JAX artifact fields missing: {sorted(jax_fields - set(aa))} | "
        f"command {secs['18c']:.1f} s | launches {launches['18c']}")
    if broken or jax_fields - set(aa) or aa["n_images"] != CLI_ATTACK_IMAGES:
        raise RuntimeError(f"18c: broken {broken}, missing {jax_fields - set(aa)}")
    if min(launches["18c"][k] for k in K1_K3) == 0:
        raise RuntimeError(f"18c: a kernel was not launched by the attacks: "
                           f"{launches['18c']}")

    # 18d: one epoch of cifar_train.yaml at full width on the synthetic set,
    # then certify-lipschitz restoring the run's own best.npz
    r, rc = jobs["18d"].result()
    secs["18d train"], launches["18d"] = r["seconds"], r["launches"]
    missing = [f for f in ("metrics.jsonl", "ckpt/best.npz", "ckpt/resume.pt")
               if not (train_dir / f).exists()]
    secs["18d certify"] = rc["seconds"]
    restored = json.loads((CLI_DIR / "train_lips.jsonl.json").read_text())
    log(f"[18d train] one epoch in {secs['18d train']:.1f} s (command) | missing "
        f"{missing} | launches {launches['18d']} | certify-lipschitz of its best.npz: "
        f"clean {restored['clean_idx']} certified {restored['certified_idx']} in "
        f"{secs['18d certify']:.1f} s")
    if missing or restored["n_images"] != 2:
        raise RuntimeError(f"18d: missing {missing}, or no certificate of the run")
    if not (launches["18d"]["k1.launches"] and launches["18d"]["k3.launches"]):
        raise RuntimeError(f"18d: the run did not go through K1 and K3: {launches['18d']}")

    # 18e: the same run under torch.distributed.run, one NCCL rank
    r = jobs["18e"].result()
    secs["18e"] = r["seconds"]
    with np.load(train_dir / "ckpt" / "best.npz") as a, \
            np.load(ddp_dir / "ckpt" / "best.npz") as b:
        same_keys = sorted(a.files) == sorted(b.files)
        diff = max(float(np.abs(a[k] - b[k]).max()) for k in a.files) if same_keys else math.inf
    log(f"[18e multihost] one NCCL rank: best.npz max|d| against 18d {diff:.3e} "
        f"({'bit-equal' if diff == 0 else 'not bit-equal'}) | "
        f"'process 0/1' printed: {'[multihost] process 0/1' in r['stdout']} | "
        f"command {secs['18e']:.1f} s")
    if not (same_keys and diff <= 1e-6 and "[multihost] process 0/1" in r["stdout"]):
        raise RuntimeError(f"18e: the one-rank run differs from 18d by {diff}")

    # 18f: segway-certify at r = 0.01 with its figures
    r = jobs["18f"].result()
    secs["18f"] = r["seconds"]
    m = re.search(r"cells=(\d+) ub\.max=(\S+) exact\.max=(\S+) certified=(\w+)",
                  r["stdout"])
    want = json.loads((SEGWAY_DIR / "segway_f32.json").read_text())["certify"]["0.01"]
    cells, ub = int(m.group(1)), float(m.group(2))
    has_mpl = importlib.util.find_spec("matplotlib") is not None
    figures = sorted(p.name for p in plot_dir.glob("*.png")) if plot_dir.exists() else []
    near = []
    if cells != want["n_cells"]:
        from fiode_tpu_torch.control import load_segway
        from fiode_tpu_torch.control.lyapunov_ctrl import LyaQuadratic
        seg = load_segway(SEGWAY_DIR / "segway_f32.npz", dev)
        near = near_edge_cells(LyaQuadratic(seg["P"], torch.zeros(1, 3, device=dev)),
                               (want["level_lb"], want["level_ub"]), 0.01,
                               (float(math.pi / 12), 1.5, 1.5))
    log(f"[18f segway-certify] r=0.01: cells {cells} (JAX float32 {want['n_cells']}, "
        f"states at a band edge {len(near) if near else 'not needed'}) ub.max "
        f"{ub:+.5f} (JAX {want['ub_max']:+.5f}) certified {m.group(4)} (JAX "
        f"{want['certified']}) | matplotlib {'is' if has_mpl else 'is not'} "
        f"installed; figures written: {figures} | command {secs['18f']:.1f} s")
    if (abs(cells - want["n_cells"]) > len(near) or m.group(4) != str(want["certified"])
            or abs(ub - want["ub_max"]) > SEGWAY_VDOT_TOL):
        raise RuntimeError("18f: the CLI's Segway certificate is not segway_f32.json's")
    if has_mpl and figures != ["segway_traj3d.png", "segway_vdot_phase.png"]:
        raise RuntimeError(f"18f: matplotlib is installed but the figures are {figures}")



# phase 19: the example drivers, python -m fiode_tpu_torch.examples.<name>,
# in subprocesses on the card (each reporting its kernels' launches), and
# the multi-chip dry run; their outputs go to chiprun_out/drivers/
DRIVERS_DIR = ROOT / "chiprun_out" / "drivers"
DRIVER_IMAGES = 4              # 19a: CROWN and Lipschitz on test images 0-3
DRIVER_ATTACK_IMAGES = 64      # 19a
HYBRID_DRIVER_IMAGE = 502      # 19d: hybrid_sweep.json: certified, worst -0.511
WITNESS_IMAGE, WITNESS_F32 = 11, -0.083997  # 19d: float32 (ROADMAP queue 3)
WITNESS_TOL = 1e-5
LIPS_DRIVER_IMAGE = 3          # 19d: phase 14c's Lipschitz BaB, 2 rounds
PROBE_IMAGE, PROBE_SAMPLE = 11, 4096
ALPHA_DEMO_IMAGE, ALPHA_DEMO_T = 11, 20
DRYRUN_RANKS = 2               # 19e: two ranks on the one card (gloo)


def _sha(root: Path) -> dict:
    import hashlib
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def drivers_phase(dev, segway_verdict=None) -> dict:
    """[19 drivers] the example drivers on the card, at once: 19a
    full_workflow restoring the trained checkpoint (CROWN and Lipschitz on
    images 0-3 at T = 40 held to the committed streams, 64 images attacked,
    certified ⊆ robust), 19b full_workflow training one epoch at
    full width, 19c segway_workflow at the full protocol (its verdict held
    to phase 16b's), 19d hybrid_sweep, refute_witnesses, refine_workflow,
    refine_lips_workflow, alpha_crown_demo and alpha_probe on one image
    each, and 19e dryrun_multichip on two ranks of the card; then
    examples/refine_accounting.py and examples/inclusion_check.py on what
    19d wrote.  run_data/certified_full/ must be byte-equal after the
    phase."""
    import shutil
    from concurrent.futures import ThreadPoolExecutor
    t_phase = time.perf_counter()
    shutil.rmtree(DRIVERS_DIR, ignore_errors=True)
    DRIVERS_DIR.mkdir(parents=True)
    before = _sha(CERT_DIR)
    run_dir = str(CERT_DIR.relative_to(ROOT))
    secs, launches = {}, {}

    def driver(tag, name, args):
        r = run_cli(tag, args, module=f"fiode_tpu_torch.examples.{name}")
        secs[tag], launches[tag] = r["seconds"], r["launches"]
        return r

    def results(sub, name):
        return json.loads((DRIVERS_DIR / sub / name).read_text())

    demo_keys = set(json.loads((ROOT / "examples" / "demo_RESULTS.json").read_text()))
    crown_art = json.loads((CERT_DIR / "certify_stream_full_rep2.jsonl.json").read_text())
    lips_art = json.loads((CERT_DIR / "lips_stream_full.jsonl.json").read_text())

    # 19a-19e at once: the training epoch and the Segway workflow are
    # host-bound, the sweeps are not, and every process pays its start-up
    cert_out = DRIVERS_DIR / "certify"
    cert_out.mkdir()
    lips_summary = cert_out / f"lips_summary_{LIPS_DRIVER_IMAGE}.json"
    # the Lipschitz summary of images 0-15 with every other image marked
    # certified, so that the driver refines phase 14c's image alone
    lips_summary.write_text(json.dumps(dict(
        lips_art, n_images=16,
        certified_idx=sorted(set(range(16)) - {LIPS_DRIVER_IMAGE}))))
    common = ["--run-dir", run_dir, "--out-dir", str(cert_out)]
    jobs = {
        # 19a: full_workflow restoring the trained checkpoint at full width;
        # the checkpoint trained 300 epochs (scale_nominal off from epoch 10)
        "19a": ("full_workflow", [
            "--restore", "--run-dir", run_dir, "--epochs", "300", "--T", str(CERT_T),
            "--certify-images", str(DRIVER_IMAGES), "--attack-images",
            str(DRIVER_ATTACK_IMAGES), "--out-dir", str(DRIVERS_DIR / "full_restore"),
            f"++val_batch_size={DRIVER_ATTACK_IMAGES}"]),
        "19b full_workflow train": ("full_workflow", [
            "--epochs", "1", "--synthetic-size", "1024", "--T", "10",
            "--certify-images", "2", "--attack-images", "32",
            "--out-dir", str(DRIVERS_DIR / "full_train"), "++val_batch_size=32"]),
        "19c segway_workflow": ("segway_workflow", ["--out-dir", str(DRIVERS_DIR / "segway")]),
        "19d hybrid_sweep": ("hybrid_sweep", [*common, "--images", str(HYBRID_DRIVER_IMAGE)]),
        "19d refute_witnesses": ("refute_witnesses", [*common, "--images",
                                                      str(WITNESS_IMAGE)]),
        "19d refine_workflow": ("refine_workflow", [*common, "--images", "15", "--end", "16",
                                                    "--rounds", "2"]),
        "19d refine_lips_workflow": ("refine_lips_workflow", [
            *common, "--summary", str(lips_summary), "--end", "16", "--rounds",
            str(LIPS_REFINE_ROUNDS)]),
        "19d alpha_crown_demo": ("alpha_crown_demo", [
            *common, "--start", str(ALPHA_DEMO_IMAGE), "--end", str(ALPHA_DEMO_IMAGE + 1),
            "--T", str(ALPHA_DEMO_T), "--alpha-iters", "2"]),
        "19d alpha_probe": ("alpha_probe", [*common, "--images", str(PROBE_IMAGE),
                                            "--sample", str(PROBE_SAMPLE)]),
    }

    def dryrun():
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", "import json\nfrom fiode_tpu_torch.entry import "
             f"dryrun_multichip\nprint(json.dumps(dryrun_multichip({DRYRUN_RANKS})))"],
            cwd=ROOT, capture_output=True, text=True, timeout=CLI_TIMEOUT)
        secs["19e dryrun_multichip"] = time.perf_counter() - t0
        if proc.returncode:
            log(f"[19e dryrun] failed:\n{proc.stdout[-3000:]}\n{proc.stderr[-6000:]}")
            raise RuntimeError("19e: dryrun_multichip failed")
        return proc.stdout.strip().splitlines()

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs) + 1) as pool:
        futures = [pool.submit(driver, tag, name, args)
                   for tag, (name, args) in jobs.items()]
        dry = pool.submit(dryrun)
        for f in futures:
            f.result()
        dry_lines = dry.result()
    secs["19a-19e at once"] = time.perf_counter() - t0

    got = results("full_restore", "RESULTS.json")
    imgs = range(DRIVER_IMAGES)
    checks = {"crown certified_idx": (got["crown"]["certified_idx"], crown_art["certified_idx"]),
              "lipschitz certified_idx": (got["lipschitz"]["certified_idx"],
                                          lips_art["certified_idx"]),
              "lipschitz larger_T_certified_idx": (got["lipschitz"]["larger_T_certified_idx"],
                                                   lips_art["larger_T_certified_idx"])}
    log(f"[19a full_workflow --restore] images 0-{DRIVER_IMAGES - 1} at T={CERT_T}: "
        + " | ".join(f"{k} {a} (artifact {[i for i in b if i in imgs]})"
                     for k, (a, b) in checks.items())
        + f" | CROWN {got['crown']['cells_per_sec']:,.0f} image-cells/s in "
        f"{got['crown']['seconds']:.1f} s | attack {got['autoattack']['n_images']} images: "
        f"robust {len(got['autoattack']['robust_idx'])} in {got['attack_seconds']:.1f} s | "
        f"consistent {got['consistent']} | command {secs['19a']:.1f} s | launches "
        f"{launches['19a']}")
    for k, (a, b) in checks.items():
        if a != [i for i in b if i in imgs]:
            raise RuntimeError(f"19a: {k} {a} is not the artifact's")
    if not got["consistent"] or got["autoattack"]["n_images"] != DRIVER_ATTACK_IMAGES:
        raise RuntimeError(f"19a: consistent {got['consistent']}, "
                           f"{got['autoattack']['n_images']} images attacked")
    if demo_keys - set(got) or got["certify_scale_nominal"]:
        raise RuntimeError(f"19a: fields missing {demo_keys - set(got)}, or the "
                           "certificate took the scaled field")
    if min(launches["19a"][k] for k in K1_K3) == 0:
        raise RuntimeError(f"19a: a kernel was not launched: {launches['19a']}")


    got = results("full_train", "RESULTS.json")
    losses = [json.loads(ln)["training_loss"] for ln in
              (DRIVERS_DIR / "full_train" / "metrics.jsonl").read_text().splitlines()
              if "training_loss" in ln]
    missing = demo_keys - {"restore_seconds"} - set(got)
    tag = "19b full_workflow train"
    log(f"[19b full_workflow train] 1 epoch: {len(losses)} logged losses "
        f"{[round(v, 4) for v in losses]} | val_err {got['validation_error']:.4f} | "
        f"train {got['train_seconds']:.1f} s | crown {got['crown']['certified_idx']} "
        f"lipschitz {got['lipschitz']['certified_idx']} at T=10 | robust "
        f"{len(got['autoattack']['robust_idx'])}/{got['autoattack']['n_images']} | "
        f"fields missing {sorted(missing)} | command {secs[tag]:.1f} s | launches "
        f"{launches[tag]}")
    if not losses or not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"19b: training losses {losses}")
    if not 0.0 <= got["validation_error"] <= 1.0 or missing:
        raise RuntimeError(f"19b: val_err {got['validation_error']}, missing {missing}")
    if min(launches[tag][k] for k in K1_K3) == 0:
        raise RuntimeError(f"19b: a kernel was not launched: {launches[tag]}")

    seg = results("segway", "SEGWAY_RESULTS.json")
    ref = json.loads((SEGWAY_DIR / "segway_f32.json").read_text())["certify"]["0.01"]
    want_seg, source = ((segway_verdict, "phase 16b") if segway_verdict is not None
                        else (ref["certified"], "segway_f32.json"))
    seg_keys = set(json.loads((ROOT / "examples" / "segway_RESULTS.json").read_text()))
    log(f"[19c segway_workflow] best barrier loss {seg['best_barrier_loss']:.5f} | r=0.01: "
        f"cells {seg['n_cells']} ub_max {seg['vdot_ub_max']:+.5f} certified "
        f"{seg['certified']} ({source}: {want_seg}) | train {seg['train_seconds']:.1f} s, "
        f"certify {seg['certify_seconds']:.1f} s | command "
        f"{secs['19c segway_workflow']:.1f} s | launches {launches['19c segway_workflow']}")
    if seg["certified"] != want_seg or not math.isfinite(seg["best_barrier_loss"]):
        raise RuntimeError(f"19c: certified {seg['certified']}, {source} {want_seg}")
    if seg_keys - {"recertified_sound_interval"} != set(seg):
        raise RuntimeError(f"19c: fields {sorted(seg)} are not the JAX driver's")
    if any(launches["19c segway_workflow"][k] for k in K1_K3):
        raise RuntimeError("19c: a TPU kernel's port was launched on the Segway path")

    hyb = results("certify", "hybrid_sweep.json")["stats"]
    log(f"[19d hybrid_sweep] image {HYBRID_DRIVER_IMAGE}: worst {hyb[0]['worst']:+.6f} "
        f"(artifact -0.511286) violated {hyb[0]['n_violated']} certified "
        f"{hyb[0]['certified']} | {hyb[0]['seconds']:.1f} s | command "
        f"{secs['19d hybrid_sweep']:.1f} s | launches {launches['19d hybrid_sweep']}")
    if [s["image"] for s in hyb] != [HYBRID_DRIVER_IMAGE] or not hyb[0]["certified"]:
        raise RuntimeError(f"19d: the hybrid sweep did not certify {HYBRID_DRIVER_IMAGE}")
    wit = results("certify", "exact_witnesses.json")["witnesses"][0]
    log(f"[19d refute_witnesses] image {WITNESS_IMAGE}: witness "
        f"{wit['witness_value']:+.6f} (float32 {WITNESS_F32:+.6f}, artifact -0.076205) "
        f"{wit['verdict']} | command {secs['19d refute_witnesses']:.1f} s | launches "
        f"{launches['19d refute_witnesses']}")
    if not abs(wit["witness_value"] - WITNESS_F32) <= WITNESS_TOL:
        raise RuntimeError(f"19d: witness {wit['witness_value']}, float32 {WITNESS_F32}")
    ref_full = results("certify", "refine_full.json")
    s15 = ref_full["stats"][0]
    f_viol, f_rounds, f_boxes = REFINE_F32[15]
    log(f"[19d refine_workflow] image 15, 2 rounds: violated {s15['base_violated']} "
        f"(float32 {f_viol}) rounds {s15['rounds']} ({f_rounds}) boxes "
        f"{s15['boxes_evaluated']} ({f_boxes}) certified {s15['certified']} | "
        f"matmul_precision {ref_full['matmul_precision']} | command "
        f"{secs['19d refine_workflow']:.1f} s | launches {launches['19d refine_workflow']}")
    if (abs(s15["base_violated"] - f_viol) > max(2, REFINE_VIOLATED_TOL * f_viol)
            or s15["rounds"] != f_rounds or not s15["certified"]):
        raise RuntimeError(f"19d: refine_workflow on image 15: {s15}")
    lips = results("certify", "refine_lips_full.json")["stats"]
    s3 = lips[0]
    log(f"[19d refine_lips_workflow] image {LIPS_DRIVER_IMAGE}, {LIPS_REFINE_ROUNDS} "
        f"rounds: violated {s3['base_violated']} (float32 {LIPS_REFINE_F32}) rounds "
        f"{s3['rounds']} boxes {s3['boxes_evaluated']} certified {s3['certified']} "
        f"gave up {s3['gave_up']!r} | command {secs['19d refine_lips_workflow']:.1f} s "
        f"| launches {launches['19d refine_lips_workflow']}")
    if ([s["image"] for s in lips] != [LIPS_DRIVER_IMAGE]
            or abs(s3["base_violated"] - LIPS_REFINE_F32) > 1e-3 * LIPS_REFINE_F32
            or s3["rounds"] != LIPS_REFINE_ROUNDS or not s3["boxes_evaluated"]
            or s3["certified"] or s3["gave_up"] != "rounds"):
        raise RuntimeError(f"19d: refine_lips_workflow on image {LIPS_DRIVER_IMAGE}: "
                           f"{lips} is not phase 14c's answer")
    alpha = results("certify", "ALPHA_CROWN.json")
    log(f"[19d alpha_crown_demo] image {ALPHA_DEMO_IMAGE} at T={ALPHA_DEMO_T}: plain "
        f"{alpha['plain_certified']} certified ({alpha['plain_cells_per_sec']:,.0f} "
        f"cells/s), failing {alpha['failing_idx']}, alpha recovered "
        f"{alpha.get('alpha_recovered')} ({alpha.get('alpha_cells_per_sec', 0):,.0f} "
        f"cells/s) | command {secs['19d alpha_crown_demo']:.1f} s | launches "
        f"{launches['19d alpha_crown_demo']}")
    if alpha["failing_idx"] != [ALPHA_DEMO_IMAGE] or not math.isfinite(
            alpha["alpha_cells_per_sec"]):
        raise RuntimeError(f"19d: alpha-CROWN did not run on image {ALPHA_DEMO_IMAGE}")
    probe = results("certify", "alpha_probe.json")[0]
    log(f"[19d alpha_probe] image {PROBE_IMAGE}: {probe} | command "
        f"{secs['19d alpha_probe']:.1f} s | launches {launches['19d alpha_probe']}")
    if probe["plain_violated"] < PROBE_SAMPLE or not all(
            0.0 <= probe[f"alpha{k}_closed_frac"] <= 1.0 for k in (2, 4, 8)):
        raise RuntimeError(f"19d: alpha_probe {probe}")

    # the two host-side folds of the JAX package, unchanged, on what the
    # drivers wrote
    for script, extra in (
            ("refine_accounting.py", []),
            ("inclusion_check.py", ["--attack", str(
                CERT_DIR / "autoattack_full_standard_512_tmax01.json")])):
        proc = subprocess.run(
            [sys.executable, str(ROOT / "examples" / script), "--run-dir", str(cert_out),
             "--summary", str(CERT_DIR / "certify_stream_full.summary.json"), *extra],
            cwd=ROOT, capture_output=True, text=True, timeout=120)
        log(f"[19d {script}] rc {proc.returncode} | {proc.stdout.strip()[-300:]}")
        if proc.returncode:
            raise RuntimeError(f"19d: {script} failed: {proc.stderr[-2000:]}")
    acct = json.loads((cert_out / "refine_accounting.json").read_text())
    inc = json.loads((cert_out / "inclusion_tmax01.json").read_text())
    if acct["recovered"] != ref_full["recovered"] or not inc["inclusion_holds"]:
        raise RuntimeError(f"19d: the accounting recovered {acct['recovered']}, the "
                           f"refinement {ref_full['recovered']}; inclusion {inc}")

    # 19e: the multi-chip dry run, two ranks on the card
    lines = dry_lines
    report = json.loads(lines[-1])
    launches["19e"] = report["launches"]
    log(f"[19e dryrun_multichip] {lines[-2]} | backend {report['backend']} | losses "
        f"tiny {report['tiny_loss']:.5f} KWLarge {report['kwlarge_loss']:.5f} | CROWN "
        f"chunk max {report['crown_chunk_max']:+.6f} | mesh certified "
        f"{report['certify']['mesh']['certified']} refined "
        f"{report['certify']['mesh']['refined']} (equal to unsharded) | APGD-CE "
        f"{report['apgd_rows']} rows a rank, max attempts {report['apgd_max_attempts']} | "
        f"{secs['19e dryrun_multichip']:.1f} s | rank 0's launches {report['launches']}")
    if lines[-2] != f"dryrun_multichip({DRYRUN_RANKS}) OK":
        raise RuntimeError("19e: the dry run did not report OK")

    after = _sha(CERT_DIR)
    if after != before:
        raise RuntimeError(f"19: run_data/certified_full changed: "
                           f"{sorted(k for k in set(before) | set(after) if before.get(k) != after.get(k))}")
    seconds = time.perf_counter() - t_phase
    log(f"[19 drivers] phase 19 in {seconds:.1f} s | run_data/certified_full byte-equal | "
        + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items()))
    return {"launches": launches, "seconds": seconds}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", choices=("all", "certify", "train", "control",
                                         "ode", "attack", "cli", "drivers"),
                    default="all")
    phases = ap.parse_args().phases
    only_certify, only_train = phases == "certify", phases == "train"
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs on a GPU")
    from fiode_tpu_torch.entry import certify_model, flagship
    from fiode_tpu_torch.models.backbones import KWLargeBackbone
    from fiode_tpu_torch.ops._build import (BUILD_DIR, load_cpp_library,
                                            load_library)
    from fiode_tpu_torch.ops.cayley import apply_freq_matrices, cayley_conv_kernel
    from fiode_tpu_torch.ops.fused_cayley_conv import _launch, fused_freq_apply
    from fiode_tpu_torch.ops import fused_crown as fused_crown_module
    from fiode_tpu_torch.ops import fused_qp as fused_qp_module
    from fiode_tpu_torch.ops import fused_rhs as fused_rhs_module
    from fiode_tpu_torch.ops.fused_rhs import RhsParams, fused_rhs, rhs_reference

    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    # 1. device ---------------------------------------------------------------
    smi = card()["line"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[1 device] {torch.cuda.get_device_name(0)} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32} cudnn.allow_tf32="
        f"{torch.backends.cudnn.allow_tf32}")

    if phases == "control":  # no kernel on this path: nothing to build
        segway_phase(dev, smi)
        log(smi)
        log("partial run (--phases control): no result line")
        return

    # 2. build ----------------------------------------------------------------
    t0 = time.perf_counter()
    # K1 and K2 are compiled per pair of tile counts: the flagship's
    # (n = 10) and phase 3's wide state (n = 100); one nvcc each, together
    builds = [lambda: load_library("fused_cayley_conv"),
              lambda: fused_rhs_module.build(N_CLASSES, MLP)]
    certifies = phases in ("all", "certify", "cli", "drivers")
    if phases in ("all", "certify", "cli", "drivers"):
        builds.append(lambda: load_cpp_library("grid_enum"))
    if certifies:  # K4 and K5 at the certify configuration's widths
        builds.append(lambda: fused_crown_module.build(N_CLASSES, MLP, MLP,
                                                       N_CLASSES))
        builds.append(lambda: fused_qp_module.build(N_CLASSES))
    if phases == "all":
        builds.append(lambda: fused_rhs_module.build(WIDE_N, MLP))
    if phases in ("all", "drivers"):  # the dry run's 3-class, mlp-16 certifier
        builds.append(lambda: fused_rhs_module.build(3, 16))
        builds.append(lambda: fused_crown_module.build(3, 16, 16, 3))
        builds.append(lambda: fused_qp_module.build(3))
    with ThreadPoolExecutor(len(builds)) as pool:
        list(pool.map(lambda build: build(), builds))
    build_s = time.perf_counter() - t0
    log(f"[2 build] K1 + K2 ({'three widths' if phases == 'all' else 'two widths' if phases == 'drivers' else 'one width'}) + K3 "
        f"{'+ K4 + K5 ' if certifies else ''}"
        f"{'+ grid_enum (g++) ' if phases in ('all', 'certify', 'cli', 'drivers') else ''}built in {build_s:.1f} s "
        f"into {BUILD_DIR}")
    # ptxas on every kernel; the main path's own (the flagship's K1, and its
    # K2 without weight gradients: every launch of phases 5, 9 and 10) may
    # spill a stray register, not a fragment
    spilled = []
    for p in sorted(BUILD_DIR.glob("*.log")):
        lines = p.read_text().splitlines()
        for i, ln in enumerate(lines):
            if "Compiling entry function" in ln:
                info = " ".join(x.replace("ptxas info    :", "").strip()
                                for x in lines[i + 2:i + 4])
                name = ln.split(chr(39))[1]
                flags = "".join(re.findall(r"Lb([01])E", name))
                kernel = next((k for k in ("fused_rhs_backward_kernel",
                                           "fused_rhs_kernel",
                                           "fused_crown_kernel",
                                           "fused_cone_qp_kernel") if k in name),
                              name[-40:])
                log(f"    ptxas {p.stem[3:]} {kernel}<{flags}>: {info}")
                hot = kernel == "fused_rhs_kernel" or flags.endswith("0")
                stores = int(re.search(r"(\d+) bytes spill stores", info).group(1))
                if (p.name.endswith(f"mt{MLP // 8}-fiode_rhs_nt{-(-N_CLASSES // 8)}.log")
                        and "fused_rhs" in kernel and hot and stores > MAX_SPILL_BYTES):
                    spilled.append(f"{kernel}<{flags}> {stores} bytes")
    if spilled:
        raise RuntimeError(f"kernels of the main path spill registers: {spilled}")

    if phases != "all":
        if only_certify:
            certify_phases(dev)
        elif only_train:
            train_phase(dev)
            train_modes_phase(dev)
        elif phases == "attack":
            attack_phase(dev)
        elif phases == "cli":
            cli_phase(dev)
        elif phases == "drivers":
            drivers_phase(dev)
        else:
            ode_phases(flagship(N_CLASSES, MLP, generator=gen(SEED), device=dev), dev)
        log(smi)
        log(f"partial run (--phases {phases}): no result line")
        return

    model = flagship(N_CLASSES, MLP, generator=gen(SEED), device=dev)
    errs = {"k1": 0.0, "k3": 0.0}

    # 3. K1 vs plain ----------------------------------------------------------
    with torch.no_grad():
        p = rhs_weights(model.dynamics)
        h = simplex_rows(K1_BATCH, N_CLASSES, 1, dev)
        xc = torch.randn(K1_BATCH, MLP, generator=gen(2)).to(dev)
        dyn = model.dynamics
        for sn in (False, True):
            args = (dyn.alpha_1, dyn.sigma_1, dyn.alpha_2, sn, dyn.qp_iters)
            got = fused_rhs(h, xc, p, *args)
            want = rhs_reference(h, xc, p, *args)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            errs["k1"] = max(errs["k1"], err)
            log(f"[3 K1] B={K1_BATCH} n={N_CLASSES} mlp={MLP} scale_nominal={sn}: "
                f"max|d|={err:.3e} (tol {K1_TOL:g})")
            if not err <= K1_TOL:
                raise RuntimeError(f"K1 disagrees with its plain version: {err}")
        # a wide state, and both versions against a float64 evaluation of
        # the RHS on the unsquashed f: certificates are float32, and this
        # holds the 3xTF32 products to the plain float32 version's accuracy.
        # With sigma_1 = 0 the barrier is flat at 0 and no exp stands between
        # the products and the output (at the dynamics' sigma_1 an ulp of
        # exp, times alpha_1, is most of both errors).
        for n_w, seed, sigma_1 in ((N_CLASSES, 7, dyn.sigma_1), (N_CLASSES, 7, 0.0),
                                   (WIDE_N, 8, dyn.sigma_1), (WIDE_N, 8, 0.0)):
            wts = [0.3 * torch.randn(*shape, generator=gen(seed)).to(dev)
                   for shape in ((MLP, n_w), (MLP, MLP), (n_w, MLP), (MLP,), (n_w,))]
            pw = fused_rhs_module.pack_rhs_params(*wts)
            hw = simplex_rows(K1_BATCH, n_w, seed + 2, dev)
            xw = 0.5 * torch.randn(K1_BATCH, MLP, generator=gen(seed + 4)).to(dev)
            args = (dyn.alpha_1, sigma_1, dyn.alpha_2, False, dyn.qp_iters)
            got = fused_rhs(hw, xw, pw, *args)
            again = fused_rhs(hw, xw, pw, *args)
            want = rhs_reference(hw, xw, pw, *args)
            p64 = RhsParams(*(t.double() for t in pw))
            exact = rhs_reference(hw.double(), xw.double(), p64, *args[:4], 60)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            e_kernel = (got - exact).abs().max().item()
            e_plain = (want - exact).abs().max().item()
            errs["k1"] = max(errs["k1"], err)
            log(f"[3 K1] B={K1_BATCH} n={n_w} mlp={MLP} scale_nominal=False "
                f"sigma_1={sigma_1:g}: "
                f"max|d|={err:.3e} (tol {K1_TOL:g}) | against float64: kernel "
                f"{e_kernel:.3e}, plain float32 {e_plain:.3e} (the kernel's may "
                f"be at most twice the plain version's)")
            if not err <= K1_TOL:
                raise RuntimeError(f"K1 disagrees with its plain version: {err}")
            if not e_kernel <= 2 * e_plain:
                raise RuntimeError(f"K1 is further from float64 than twice the "
                                   f"plain version: {e_kernel} vs {e_plain}")
            if not torch.equal(got, again):
                raise RuntimeError("two K1 launches differ")

    # 4. K3 vs plain ----------------------------------------------------------
    def conv_qs(backbone, shapes):
        qs = []
        for i, (ci, co, k, n) in enumerate(shapes):
            conv = backbone.convs[i]
            if tuple(conv.weight.shape) != (co, ci, k, k):
                raise RuntimeError(f"conv {i} weight is {tuple(conv.weight.shape)}")
            qs.append(cayley_conv_kernel(conv.weight, conv.alpha, n))
        return qs

    def check_k3(tag, x, Q):
        """K3 on x with Q (F, co, ci) against the dense DFT, and a repeat."""
        Qr, Qi = Q.real.contiguous(), Q.imag.contiguous()
        got = fused_freq_apply(x, Qr, Qi)
        again = fused_freq_apply(x, Qr, Qi)
        want = apply_freq_matrices(x, Q, impl="dft")
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        errs["k3"] = max(errs["k3"], err)
        log(f"[4 K3] {tag} {x.shape[1]}->{Q.shape[1]} @{x.shape[-1]} "
            f"B={x.shape[0]}: max|d|={err:.3e} (tol {K3_TOL:g})")
        if not err <= K3_TOL:
            raise RuntimeError(f"K3 disagrees with its plain version: {err}")
        if not torch.equal(got, again):
            raise RuntimeError("two K3 launches differ")

    with torch.no_grad():
        q_by_shape = dict(enumerate(conv_qs(model.backbone, CONV_SHAPES)))
        for i, (ci, co, k, n) in enumerate(CONV_SHAPES):
            Q = q_by_shape[i]
            x = torch.randn(K3_BATCH, ci, n, n, generator=gen(10 + i)).to(dev)
            check_k3(f"layer {i}", x, Q)
            # the transposed shape the conv backward gives K3, as a forward
            g = torch.randn(K3_BATCH, co, n, n, generator=gen(14 + i)).to(dev)
            check_k3(f"layer {i} transposed", g,
                     Q.conj().transpose(1, 2).resolve_conj())
        mnist = KWLargeBackbone(out_dim=N_CLASSES, act="GroupSort",
                                in_channels=1, img_size=28,
                                generator=gen(SEED)).to(dev)
        for i, Q in enumerate(conv_qs(mnist, MNIST_CONV_SHAPES)):
            ci, co, k, n = MNIST_CONV_SHAPES[i]
            x = torch.randn(K3_BATCH, ci, n, n, generator=gen(18 + i)).to(dev)
            check_k3(f"MNIST layer {i}", x, Q)
        # past the radix path's sizes: the direct passes, one plane a block
        ci, co, k, n = K3_WIDE
        Qw = cayley_conv_kernel(0.1 * torch.randn(co, ci, k, k, generator=gen(22)).to(dev),
                                torch.tensor(1.1, device=dev), n)
        xw = torch.randn(K3_BATCH, ci, n, n, generator=gen(23)).to(dev)
        check_k3(f"n={n}", xw, Qw)
        Qwr, Qwi = Qw.real.contiguous(), Qw.imag.contiguous()
        k3_wide = {"kernel": cuda_ms(lambda: fused_freq_apply(xw, Qwr, Qwi), 10),
                   "plain": cuda_ms(lambda: apply_freq_matrices(xw, Qw, impl="dft"), 5),
                   "fft": cuda_ms(lambda: apply_freq_matrices(xw, Qw, impl="fft"), 10)}
        k3_wide["bound"], k3_wide_by = conv_bound(K3_BATCH, ci, co, n)
        log(f"[4 time] K3 {ci}->{co} @{n} B={K3_BATCH}: kernel {k3_wide['kernel']:.3f} "
            f"ms | plain dft {k3_wide['plain']:.3f} ms | fft {k3_wide['fft']:.3f} ms | "
            f"bound {k3_wide['bound']:.4f} ms ({k3_wide_by}), "
            f"{100 * k3_wide['bound'] / k3_wide['kernel']:.1f}% of it | stages "
            + (", ".join(f"{k} {v:.3f} ms" for k, v in k3_stage_ms(
                lambda t: fused_freq_apply(t, Qwr, Qwi), xw).items()) or "not measured"))

    # 5. end to end -----------------------------------------------------------
    def checked_solve(x):
        sol = model.solve(x)
        if sol.n_accepted + sol.n_rejected >= model.max_steps:
            raise RuntimeError(f"solve used its whole step budget ({model.max_steps})")
        return sol

    x = torch.rand(E2E_BATCH, 3, 32, 32, generator=gen(3)).to(dev)
    with torch.no_grad():
        since = counters()
        sol_k = checked_solve(x)
        torch.cuda.synchronize()
        launches = launched(since)
        with plain_path():
            sol_p = checked_solve(x)
    yk, yp = sol_k.ys[-1], sol_p.ys[-1]
    e2e_err = (yk - yp).abs().max().item()
    row_sum_err = (yk.sum(-1) - 1).abs().max().item()
    log(f"[5 e2e] B={E2E_BATCH}: kernel nfe={sol_k.nfe} acc={sol_k.n_accepted} "
        f"rej={sol_k.n_rejected} | plain nfe={sol_p.nfe} | max|d|={e2e_err:.3e} "
        f"(tol {E2E_TOL:g}) | max|sum h - 1|={row_sum_err:.2e} | launches {launches}")
    if tuple(yk.shape) != (E2E_BATCH, N_CLASSES) or not torch.isfinite(yk).all():
        raise RuntimeError(f"bad endpoint: shape {tuple(yk.shape)} or non-finite")
    if not e2e_err <= E2E_TOL:
        raise RuntimeError(f"kernel path disagrees with the plain path: {e2e_err}")
    if not row_sum_err <= E2E_TOL:
        raise RuntimeError(f"endpoint left the simplex: {row_sum_err}")
    if sol_k.nfe != sol_p.nfe:
        raise RuntimeError(f"NFE differs: kernel {sol_k.nfe} plain {sol_p.nfe}")
    if launches["k1.launches"] != sol_k.nfe:
        raise RuntimeError(f"K1 launched {launches['k1.launches']} times, NFE {sol_k.nfe}")
    if launches["k3.launches"] != len(CONV_SHAPES):
        raise RuntimeError(f"K3 launched {launches['k3.launches']} times, "
                           f"want {len(CONV_SHAPES)} per forward")
    # training mode changes nothing: the solve never applies dropout
    model.train()
    with torch.no_grad():
        sol_t = checked_solve(x)
    model.eval()
    same = torch.equal(sol_t.ys, sol_k.ys) and sol_t.nfe == sol_k.nfe
    log(f"[5 e2e] training-mode solve: nfe={sol_t.nfe}, equal to the eval-mode "
        f"solve: {same}")
    if not same:
        raise RuntimeError("a training-mode solve differs from the eval-mode solve")

    # 6. timing ---------------------------------------------------------------
    xt = torch.rand(TIME_BATCH, 3, 32, 32, generator=gen(4)).to(dev)
    solve_ms = {"kernel": [], "plain": []}
    nfe, end = {}, {}
    with torch.no_grad():
        checked_solve(xt[:256])  # warm-up of both paths
        with plain_path():
            checked_solve(xt[:256])
        for which in ("plain", "kernel", "kernel", "plain"):
            ctx = plain_path() if which == "plain" else contextlib.nullcontext()
            with ctx:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                sol = checked_solve(xt)
                torch.cuda.synchronize()
                solve_ms[which].append(1e3 * (time.perf_counter() - t0))
                nfe[which], end[which] = sol.nfe, sol.ys[-1]
    # the timed solves at full batch are held to phase 5's gates too
    big_err = (end["kernel"] - end["plain"]).abs().max().item()
    log(f"[6 e2e] B={TIME_BATCH}: kernel nfe={nfe['kernel']} plain "
        f"nfe={nfe['plain']} | max|d|={big_err:.3e} (tol {E2E_TOL:g})")
    if not (torch.isfinite(end["kernel"]).all() and big_err <= E2E_TOL):
        raise RuntimeError(f"B={TIME_BATCH}: kernel path disagrees: {big_err}")
    if nfe["kernel"] != nfe["plain"]:
        raise RuntimeError(f"B={TIME_BATCH}: NFE differs: {nfe}")
    for which in ("kernel", "plain"):
        ms = min(solve_ms[which])
        log(f"[6 time] solve B={TIME_BATCH} {which}: {ms:.1f} ms/solve "
            f"(runs {[round(v, 1) for v in solve_ms[which]]}), nfe={nfe[which]}, "
            f"{TIME_BATCH * nfe[which] / (ms / 1e3):.4g} sample-NFE/s")
    with torch.no_grad():
        wall, busy, top, top_ops = device_breakdown(lambda: checked_solve(xt))
    log(f"[6 profile] solve B={TIME_BATCH} kernel path under torch.profiler: "
        f"wall {wall:.1f} ms, device busy "
        + (f"{busy:.1f} ms (idle share {1 - busy / wall:.2f}); costliest on "
           "the device: " + "; ".join(f"{name[:60]} {ms:.2f} ms" for name, ms in top)
           if busy > 0 else "not measured (the profiler saw no device time)"))
    # the PyTorch operators whose own kernels cost the most, by input shape
    for name, shapes, calls, ms in top_ops:
        log(f"[6 profile]   {ms:7.2f} ms  {calls:4d} x {name} {shapes[:110]}")

    with torch.no_grad():
        h = simplex_rows(TIME_BATCH, N_CLASSES, 5, dev)
        xc = torch.randn(TIME_BATCH, MLP, generator=gen(6)).to(dev)
        args = (dyn.alpha_1, dyn.sigma_1, dyn.alpha_2, True, dyn.qp_iters)
        k1_plain = cuda_ms(lambda: rhs_reference(h, xc, p, *args), 20)
        k1_ms = kernel_ms(lambda: fused_rhs(h, xc, p, *args), K1_KERNELS)
        k1_call = cuda_ms(lambda: fused_rhs(h, xc, p, *args), 20)
        k1_bound, k1_by = rhs_bound(TIME_BATCH, N_CLASSES, MLP, dyn.qp_iters)
        log(f"[6 time] K1 B={TIME_BATCH}: kernel {k1_ms:.4f} ms | plain "
            f"{k1_plain:.4f} ms | bound {k1_bound:.4f} ms ({k1_by}), "
            f"{100 * k1_bound / k1_ms:.1f}% of it | {k1_call:.4f} ms per call "
            f"between events, host included")
        # each layer's K3 forward, and its transposed launch (the conv
        # backward: K3 on Q^H through swapped strides), against the plain
        # dense DFT, torch.fft and the layer's bound
        k3 = {d: {"kernel": 0.0, "plain": 0.0, "fft": 0.0, "bound": 0.0,
                  "bytes": 0.0, "operations": 0.0}
              for d in ("forward", "transposed")}
        for i, (ci, co, k, n) in enumerate(CONV_SHAPES):
            Q = q_by_shape[i]
            Qr, Qi = Q.real.contiguous(), Q.imag.contiguous()
            QH = Q.conj().transpose(1, 2).resolve_conj().contiguous()
            for d, cin, cout, Qd, run in (
                    ("forward", ci, co, Q,
                     lambda x: fused_freq_apply(x, Qr, Qi)),
                    ("transposed", co, ci, QH,
                     lambda x: _launch(x, Qr, Qi, adjoint=True))):
                x = torch.randn(TIME_BATCH, cin, n, n, generator=gen(20 + i)).to(dev)
                t = {impl: cuda_ms(lambda: apply_freq_matrices(x, Qd, impl=impl), 5)
                     for impl in ("dft", "fft")}
                t["plain"] = t.pop("dft")
                t["kernel"] = cuda_ms(lambda: run(x), 5)
                stages = k3_stage_ms(run, x)
                t["bound"], by = conv_bound(TIME_BATCH, cin, cout, n)
                for key in t:
                    k3[d][key] += t[key]
                k3[d][by] += t["bound"]  # the bound's share of each kind
                log(f"[6 time] K3 layer {i} {d} {cin}->{cout} @{n} B={TIME_BATCH}: "
                    f"kernel {t['kernel']:.3f} ms | plain dft {t['plain']:.3f} ms | "
                    f"fft {t['fft']:.3f} ms | bound {t['bound']:.3f} ms ({by}), "
                    f"{100 * t['bound'] / t['kernel']:.1f}% of it | launches "
                    f"(profiler) "
                    + (", ".join(f"{k} {v:.3f} ms" for k, v in stages.items())
                       or "not measured"))
                del x
                torch.cuda.empty_cache()
        for d, t in k3.items():
            log(f"[6 time] K3 {d}, 4 layers B={TIME_BATCH}: kernel "
                f"{t['kernel']:.3f} ms | plain dft {t['plain']:.3f} ms | fft "
                f"{t['fft']:.3f} ms | bound {t['bound']:.3f} ms, "
                f"{100 * t['bound'] / t['kernel']:.1f}% of it")
        if not k3["forward"]["kernel"] < k3["forward"]["fft"]:
            log("[6 time] K3's forward is slower than torch.fft")

    # 7-10. gradients through the solve and the attack suite ---------------------
    cmodel = certify_model(t_max=T_MAX, max_steps=MAX_STEPS,
                           generator=gen(SEED), device=dev)
    k2 = k2_phase(cmodel.dynamics, dev)
    k3b = k3_backward_phase(cmodel, dev)
    grad = grad_solve_phase(cmodel, dev)
    fgrad = flagship_grad_phase(model, dev)
    attack = attack_phase(dev)
    torch.cuda.empty_cache()

    # 11-13. certification on the trained checkpoint ------------------------------
    cert = certify_phases(dev)
    errs["k1"] = max(errs["k1"], cert["lipschitz"]["k1_block_err"])
    torch.cuda.empty_cache()

    # 15. Lyapunov certified training -----------------------------------------
    train = train_phase(dev)
    torch.cuda.empty_cache()
    modes = train_modes_phase(dev)
    torch.cuda.empty_cache()

    # 16. the Segway safe controller (no TPU kernel on its path) ---------------
    seg = segway_phase(dev, smi)

    # 17. every solver, the adjoint, the cached twin, the legacy dynamics -------
    ode = ode_phases(model, dev)
    torch.cuda.empty_cache()

    # 18. the command line --------------------------------------------------------
    cli = cli_phase(dev)
    torch.cuda.empty_cache()

    # 19. the example drivers and the multi-chip dry run ---------------------------
    drivers = drivers_phase(dev, segway_verdict=seg["certified"])
    torch.cuda.empty_cache()

    by_phase = {name: {"5 forward solve": launches[name],
                       "9 gradient through the solve": grad["launches"][name],
                       "9 flagship gradient": fgrad["launches"][name],
                       "10 autoattack": attack["launches"][name],
                       "12 certify crown": cert["crown"]["launches"][name],
                       "13 certify lipschitz": cert["lipschitz"]["launches"][name],
                       "14 refine": cert["refine"]["launches"][name],
                       "15 train": train["launches"][name],
                       "15f train modes": modes["launches"][name],
                       "17 solvers and adjoint": ode["launches"][name],
                       "18a certify-crown CLI": cli["launches"]["18a"][name],
                       "18c eval-autoattack CLI": cli["launches"]["18c"][name],
                       "18d train CLI": cli["launches"]["18d"][name],
                       "19a full_workflow restore": drivers["launches"]["19a"][name],
                       "19b full_workflow train":
                           drivers["launches"]["19b full_workflow train"][name],
                       "19d hybrid_sweep": drivers["launches"]["19d hybrid_sweep"][name]}
                for name in K1_K3}
    for name in ("k1.launches", "k3.launches"):  # the certification paths' kernels
        if min(by_phase[name].values()) == 0:
            raise RuntimeError(f"{name} was not launched on a path: {by_phase[name]}")
    kf = k3["forward"]
    kernels = [
        {"name": "fused_rhs", "route": "cuda",
         "source": "fiode_tpu_torch/csrc/fused_rhs.cu",
         "replaces": "fiode_tpu/ops/fused_rhs.py:140",
         "launches": attack["launches"]["k1.launches"],
         "launches_by_phase": by_phase["k1.launches"],
         "max_abs_err": errs["k1"], "ms": k1_ms, "plain_ms": k1_plain,
         "bound_ms": k1_bound, "bound_by": k1_by, "library_ms": None},
        {"name": "fused_rhs_backward", "route": "cuda",
         "source": "fiode_tpu_torch/csrc/fused_rhs.cu",
         "replaces": "fiode_tpu/ops/fused_rhs.py:197",
         "launches": attack["launches"]["k2.launches"],
         "launches_by_phase": by_phase["k2.launches"],
         "max_abs_err": k2["err"], "ms": k2["ms"], "plain_ms": k2["plain_ms"],
         "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"], "library_ms": None},
        {"name": "fused_freq_apply", "route": "cuda",
         "source": "fiode_tpu_torch/csrc/fused_cayley_conv.cu",
         "replaces": "fiode_tpu/ops/fused_cayley_conv.py:61",
         "launches": attack["launches"]["k3.launches"],
         "launches_by_phase": by_phase["k3.launches"],
         "max_abs_err": max(errs["k3"], k3b["err"]),
         "ms": kf["kernel"], "plain_ms": kf["plain"], "bound_ms": kf["bound"],
         "bound_by": max(("bytes", "operations"), key=kf.get),
         "library_ms": kf["fft"]},
        {"name": "fused_crown", "route": "cuda",
         "source": "fiode_tpu_torch/csrc/fused_crown.cu", "replaces": None,
         "launches": cert["crown"]["k4"]["launches"],
         "launches_by_phase": {"12 certify crown": cert["crown"]["k4"]["launches"],
                               "14a refine crown BaB":
                                   cert["refine"]["crown_bab"]["k4.launches"]},
         "max_rel_err": cert["crown"]["k4"]["max_rel_err"],
         "ms": cert["crown"]["k4"]["ms"], "plain_ms": cert["crown"]["k4"]["plain_ms"],
         "bound_ms": cert["crown"]["k4"]["bound_ms"], "bound_by": "operations",
         "bound_fp32_ms": cert["crown"]["k4"]["bound_fp32_ms"], "library_ms": None},
        {"name": "fused_qp", "route": "cuda",
         "source": "fiode_tpu_torch/csrc/fused_qp.cu", "replaces": None,
         "launches": cert["crown"]["k5"]["launches"],
         "launches_by_phase": {"12 certify crown": cert["crown"]["k5"]["launches"],
                               "14a refine crown BaB":
                                   cert["refine"]["crown_bab"]["k5.launches"]},
         "max_rel_err": cert["crown"]["k5"]["max_rel_err"],
         "ms": cert["crown"]["k5"]["ms"], "plain_ms": cert["crown"]["k5"]["plain_ms"],
         "bound_ms": cert["crown"]["k5"]["bound_ms"], "bound_by": "operations",
         "library_ms": None},
    ]
    log(f"[done] phases 1-19 in {time.perf_counter() - t_start:.1f} s")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
