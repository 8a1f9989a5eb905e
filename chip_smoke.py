#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (fiode_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from fiode_tpu_torch/csrc (K1 and K2
in fused_rhs.cu, once per state width; K3 in fused_cayley_conv.cu), prints
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
    certified configuration (apgd-ce, apgd-t, fab-t, square; 512 images,
    L2 eps 0.141, 100 iterations, 5000 Square queries): K2 (scale_nominal
    off and on), K3 on Q^H as the conv backward, and K1 and K3 in every
    attack forward.

No phase catches its own failure.  Without a CUDA device it exits non-zero
and prints no result.

The second-to-last line of stdout is a JSON object describing each kernel
(its time, launches, error, plain-version time, bound and library-call
time), the last line the contract object
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import contextlib
import json
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

import torch

ROOT = Path(__file__).resolve().parent
SEED = 0
N_CLASSES, MLP = 10, 128
WIDE_N = 100  # phase 3 also holds K1 at a wide state (the JAX kernel takes n <= 128)
K1_BATCH, K3_BATCH, E2E_BATCH, TIME_BATCH = 4096, 64, 4096, 32768
K1_TOL, K3_TOL, E2E_TOL = 2e-4, 1e-4, 1e-3
MAX_SPILL_BYTES = 16  # spill stores a main-path kernel of fused_rhs.cu may have
# (ci, co, k, n) of the flagship's four CayleyConv applies (after
# space_to_depth for the strided ones)
CONV_SHAPES = ((3, 32, 3, 32), (128, 32, 2, 16), (32, 64, 3, 16),
               (256, 64, 2, 8))
# the same for the MNIST KWLarge (configs/certify/mnist_certify.yaml:
# KWLargeBackbone(in_channels=1, img_size=28))
MNIST_CONV_SHAPES = ((1, 32, 3, 28), (128, 32, 2, 14), (32, 64, 3, 14),
                     (256, 64, 2, 7))
# the H100 SXM's published peaks (NVIDIA data sheet, dense, 700 W): float32
# outside the tensor cores, TF32 on the tensor cores, HBM3; a kernel's bound
# is the larger of its bytes (each input read once, each output written
# once) over the memory rate and its flops over the peak rate of the unit
# that runs them: the products of K1 and K2 and K3's mix run on the tensor
# cores in 3xTF32, three TF32 products per float32 product; K1's and K2's
# bisection runs on float32 lanes
FP32_FLOPS, TF32_FLOPS, HBM_BYTES = 67e12, 495e12, 3.35e12
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


def log(msg: str) -> None:
    print(msg, flush=True)


def gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


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
    us = 0.0
    for e in prof.key_averages():
        if any(tag in e.key for tag in tags):
            us += getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
    return us / 1e3 / iters if us > 0 else cuda_ms(fn, iters)


K1_KERNELS = ("fused_rhs_kernel",)
K2_KERNELS = ("fused_rhs_backward_kernel", "reduce_slots_kernel")


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


def device_breakdown(fn, top: int = 8, top_ops: int = 14) -> tuple:
    """Run fn once under torch.profiler: (wall ms, device-busy ms, the top
    kernels as (name, ms), the top operators as (name, input shapes, calls,
    ms)).  The kernels are summed over the device's own kernel events only,
    so that no time is counted twice through the ops that launched them; an
    operator's time is that of the kernels it launched itself (not its
    children's), grouped by operator and input shapes.  Kernels launched
    outside any PyTorch operator (K1, K3) appear only among the kernels."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    rows = []
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            us = getattr(e, "device_time_total", None)
            if us is None:
                us = getattr(e, "cuda_time_total", 0)
            rows.append((e.key, us / 1e3))
    rows.sort(key=lambda r: -r[1])
    ops = []
    for e in prof.key_averages(group_by_input_shape=True):
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            ops.append((e.key, str(e.input_shapes), e.count, us / 1e3))
    ops.sort(key=lambda r: -r[3])
    return wall, sum(ms for _, ms in rows), rows[:top], ops[:top_ops]


def counts() -> dict:
    from fiode_tpu_torch.ops.fused_cayley_conv import fused_freq_apply
    from fiode_tpu_torch.ops.fused_rhs import fused_rhs, fused_rhs_vjp
    return {"fused_rhs": fused_rhs.launches,
            "fused_rhs_backward": fused_rhs_vjp.launches,
            "fused_freq_apply": fused_freq_apply.launches}


def reset_counts() -> None:
    from fiode_tpu_torch.ops.fused_cayley_conv import fused_freq_apply
    from fiode_tpu_torch.ops.fused_rhs import fused_rhs, fused_rhs_vjp
    fused_rhs.launches = fused_rhs_vjp.launches = fused_freq_apply.launches = 0


def plain_freq_apply(x, Qr, Qi):
    from fiode_tpu_torch.ops.cayley import apply_freq_matrices
    return apply_freq_matrices(x, torch.complex(Qr, Qi), impl="dft")


@contextlib.contextmanager
def plain_path():
    """Run solves with K1 and K3 replaced by their plain versions; their
    backward is then autograd through the plain versions (no K2)."""
    from fiode_tpu_torch.models import ivp, layers
    from fiode_tpu_torch.ops.fused_rhs import rhs_reference
    before = counts()
    with mock.patch.object(ivp, "fused_rhs", rhs_reference), \
            mock.patch.object(layers, "fused_freq_apply", plain_freq_apply):
        yield
    if counts() != before:
        raise RuntimeError("the plain path launched a kernel")


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
        before = fused_freq_apply.launches
        dx = kern()
        if fused_freq_apply.launches != before + 2:
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
    """_FusedRhsCuda.backward by the plain rhs_vjp_reference (no K2)."""
    from fiode_tpu_torch.ops.fused_rhs import RhsParams, rhs_vjp_reference
    h, xc, *w = rhs_ctx.saved_tensors
    dh, dxc, _ = rhs_vjp_reference(h, xc, g, RhsParams(*w), *rhs_ctx.consts)
    return (dh, dxc) + (None,) * 11


@contextlib.contextmanager
def plain_backwards():
    """Differentiate the kernel path's graph with the plain VJPs of K1 and
    K3 instead of K2 and K3 on Q^H."""
    from fiode_tpu_torch.ops.fused_cayley_conv import _FusedFreqApplyCuda
    from fiode_tpu_torch.ops.fused_rhs import _FusedRhsCuda
    before = counts()
    with mock.patch.object(_FusedRhsCuda, "backward",
                           staticmethod(plain_backward)), \
            mock.patch.object(_FusedFreqApplyCuda, "backward",
                              staticmethod(plain_conv_backward)):
        yield
    torch.cuda.synchronize()
    if counts() != before:
        raise RuntimeError("the plain backward launched a kernel")


def plain_conv_backward(conv_ctx, g):
    """_FusedFreqApplyCuda.backward in x by the plain dense-DFT VJP."""
    x, Qr, Qi = conv_ctx.saved_tensors
    with torch.enable_grad():
        xq = x.detach().requires_grad_()
        (dx,) = torch.autograd.grad(plain_freq_apply(xq, Qr, Qi), xq, g)
    return dx, None, None


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
        xg = x.clone().requires_grad_()
        sol = model.solve(xg)
        loss = ce_loss(sol.ys[-1], y).mean()
        fwd = counts()
        (dx,) = torch.autograd.grad(loss, xg, retain_graph=retain)
        torch.cuda.synchronize()
        return sol, (xg, loss), dx, fwd

    branches_k, branches_p = [], []
    reset_counts()
    with groupsort_branches(model, branches_k):
        sol_k, (xg, loss_k), dx_k, fwd = loss_and_grad(retain=True)
    launches = counts()
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
    want = {"fused_rhs": sol_k.nfe, "fused_rhs_backward": sol_k.nfe,
            "fused_freq_apply": 2 * len(CONV_SHAPES)}
    if launches != want or fwd["fused_freq_apply"] != len(CONV_SHAPES):
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
    reset_counts()
    sol = model.solve(xg)
    loss = ce_loss(sol.ys[-1], y).mean()
    fwd = counts()
    (dx_k,) = torch.autograd.grad(loss, xg, retain_graph=True)
    torch.cuda.synchronize()
    launches = counts()
    with plain_backwards():
        (dx_p,) = torch.autograd.grad(loss, xg)
    scale = dx_p.abs().max().item()
    d_shared = ((dx_k - dx_p).abs().max() / scale).item()
    k2 = launches["fused_rhs_backward"]
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
    if launches["fused_freq_apply"] != 2 * len(CONV_SHAPES):
        raise RuntimeError(f"K3 launches {launches}")
    return {"launches": launches}


def attack_phase(model, dev, n_iter=ATTACK_ITERS,
                 square_queries=SQUARE_QUERIES) -> dict:
    """[10 attack] run_autoattack with the standard suite, then APGD-CE
    alone on the kernel path and on the plain path."""
    from fiode_tpu_torch.attacks.apgd import apgd_ce
    from fiode_tpu_torch.experiment import BudgetedForward, run_autoattack
    x = torch.rand(ATTACK_IMAGES, 3, 32, 32, generator=gen(70)).to(dev)
    with torch.no_grad():
        y = model.predict(x).argmax(-1)
    reset_counts()
    summary, x_adv = run_autoattack(
        model, x, y, eps=ATTACK_EPS, norm="L2", n_iter=n_iter,
        square_queries=square_queries, batch_size=ATTACK_IMAGES, seed=SEED)
    torch.cuda.synchronize()
    launches = counts()
    robust = torch.zeros(ATTACK_IMAGES, dtype=torch.bool, device=dev)
    robust[summary["robust_idx"]] = True
    dist = torch.linalg.norm((x_adv - x).reshape(ATTACK_IMAGES, -1), dim=-1)
    with torch.no_grad():
        pred = model.predict(x_adv).argmax(-1)
    for name, sec in summary["attack_seconds"].items():
        log(f"[10 attack] {name}: {sec:.2f} s, {ATTACK_IMAGES / sec:.2f} images/s")
    log(f"[10 attack] {summary['attacks']} n_iter={n_iter} square_queries="
        f"{square_queries} eps={ATTACK_EPS} on {ATTACK_IMAGES} images: robust "
        f"{len(summary['robust_idx'])}/{ATTACK_IMAGES} in {summary['seconds']:.1f} s "
        f"({summary['images_per_sec']:.3f} images/s) | max attempts "
        f"{summary['max_attempts']} of max_steps {model.max_steps} (probe "
        f"{summary['probe_attempts']}), {summary['forwards']} forwards | "
        f"max L2 {dist.max().item():.5f} | launches {launches}")
    if not torch.isfinite(x_adv).all():
        raise RuntimeError("a returned adversarial is non-finite")
    if not (dist.max() <= ATTACK_EPS * (1 + 1e-5) and x_adv.min() >= 0
            and x_adv.max() <= 1):
        raise RuntimeError("a returned adversarial left the ball or the box")
    if not (pred[~robust] != y[~robust]).all():
        raise RuntimeError("a validated success is not misclassified")
    if not (dist[robust] == 0).all():
        raise RuntimeError("a robust image was modified")
    if summary["max_attempts"] >= model.max_steps:
        raise RuntimeError("an attack forward reached max_steps")
    if min(launches.values()) == 0:
        raise RuntimeError(f"a kernel was not launched by the attacks: {launches}")

    model.requires_grad_(False)
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


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs on a GPU")
    if not (ROOT / "fiode_tpu_torch" / "csrc").is_dir():
        raise SystemExit(f"chip_smoke: no fiode_tpu_torch package beside {__file__}")
    sys.path.insert(0, str(ROOT))
    from fiode_tpu_torch.entry import certify_model, flagship
    from fiode_tpu_torch.models.backbones import KWLargeBackbone
    from fiode_tpu_torch.ops._build import BUILD_DIR, load_library
    from fiode_tpu_torch.ops.cayley import apply_freq_matrices, cayley_conv_kernel
    from fiode_tpu_torch.ops.fused_cayley_conv import _launch, fused_freq_apply
    from fiode_tpu_torch.ops import fused_rhs as fused_rhs_module
    from fiode_tpu_torch.ops.fused_rhs import RhsParams, fused_rhs, rhs_reference

    dev = torch.device("cuda", 0)

    # 1. device ---------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[1 device] {torch.cuda.get_device_name(0)} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32} cudnn.allow_tf32="
        f"{torch.backends.cudnn.allow_tf32}")

    # 2. build ----------------------------------------------------------------
    t0 = time.perf_counter()
    # K1 and K2 are compiled per pair of tile counts: the flagship's
    # (n = 10) and phase 3's wide state (n = 100); one nvcc each, together
    builds = [lambda: load_library("fused_cayley_conv"),
              lambda: fused_rhs_module.build(N_CLASSES, MLP),
              lambda: fused_rhs_module.build(WIDE_N, MLP)]
    with ThreadPoolExecutor(len(builds)) as pool:
        list(pool.map(lambda build: build(), builds))
    build_s = time.perf_counter() - t0
    log(f"[2 build] K1 + K2 (two widths) + K3 built in {build_s:.1f} s into "
        f"{BUILD_DIR}")
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
                                           "fused_rhs_kernel") if k in name),
                              name[-40:])
                log(f"    ptxas {p.stem[3:]} {kernel}<{flags}>: {info}")
                hot = kernel == "fused_rhs_kernel" or flags.endswith("0")
                stores = int(re.search(r"(\d+) bytes spill stores", info).group(1))
                if (p.name.endswith(f"mt{MLP // 8}-fiode_rhs_nt{-(-N_CLASSES // 8)}.log")
                        and "fused_rhs" in kernel and hot and stores > MAX_SPILL_BYTES):
                    spilled.append(f"{kernel}<{flags}> {stores} bytes")
    if spilled:
        raise RuntimeError(f"kernels of the main path spill registers: {spilled}")

    model = flagship(N_CLASSES, MLP, generator=gen(SEED), device=dev)
    errs = {"fused_rhs": 0.0, "fused_freq_apply": 0.0}

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
            errs["fused_rhs"] = max(errs["fused_rhs"], err)
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
            errs["fused_rhs"] = max(errs["fused_rhs"], err)
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
        errs["fused_freq_apply"] = max(errs["fused_freq_apply"], err)
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

    # 5. end to end -----------------------------------------------------------
    def checked_solve(x):
        sol = model.solve(x)
        if sol.n_accepted + sol.n_rejected >= model.max_steps:
            raise RuntimeError(f"solve used its whole step budget ({model.max_steps})")
        return sol

    x = torch.rand(E2E_BATCH, 3, 32, 32, generator=gen(3)).to(dev)
    with torch.no_grad():
        reset_counts()
        sol_k = checked_solve(x)
        torch.cuda.synchronize()
        launches = counts()
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
    if launches["fused_rhs"] != sol_k.nfe:
        raise RuntimeError(f"K1 launched {launches['fused_rhs']} times, NFE {sol_k.nfe}")
    if launches["fused_freq_apply"] != len(CONV_SHAPES):
        raise RuntimeError(f"K3 launched {launches['fused_freq_apply']} times, "
                           f"want {len(CONV_SHAPES)} per forward")

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
    attack = attack_phase(cmodel, dev)

    by_phase = {name: {"5 forward solve": launches.get(name, 0),
                       "9 gradient through the solve": grad["launches"][name],
                       "9 flagship gradient": fgrad["launches"][name],
                       "10 autoattack": attack["launches"][name]}
                for name in attack["launches"]}
    kf = k3["forward"]
    kernels = [
        {"name": "fused_rhs", "route": "cuda",
         "source": "fiode_tpu_torch/csrc/fused_rhs.cu",
         "replaces": "fiode_tpu/ops/fused_rhs.py:140",
         "launches": attack["launches"]["fused_rhs"],
         "launches_by_phase": by_phase["fused_rhs"],
         "max_abs_err": errs["fused_rhs"], "ms": k1_ms, "plain_ms": k1_plain,
         "bound_ms": k1_bound, "bound_by": k1_by, "library_ms": None},
        {"name": "fused_rhs_backward", "route": "cuda",
         "source": "fiode_tpu_torch/csrc/fused_rhs.cu",
         "replaces": "fiode_tpu/ops/fused_rhs.py:197",
         "launches": attack["launches"]["fused_rhs_backward"],
         "launches_by_phase": by_phase["fused_rhs_backward"],
         "max_abs_err": k2["err"], "ms": k2["ms"], "plain_ms": k2["plain_ms"],
         "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"], "library_ms": None},
        {"name": "fused_freq_apply", "route": "cuda",
         "source": "fiode_tpu_torch/csrc/fused_cayley_conv.cu",
         "replaces": "fiode_tpu/ops/fused_cayley_conv.py:61",
         "launches": attack["launches"]["fused_freq_apply"],
         "launches_by_phase": by_phase["fused_freq_apply"],
         "max_abs_err": max(errs["fused_freq_apply"], k3b["err"]),
         "ms": kf["kernel"], "plain_ms": kf["plain"], "bound_ms": kf["bound"],
         "bound_by": max(("bytes", "operations"), key=kf.get),
         "library_ms": kf["fft"]},
    ]
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
