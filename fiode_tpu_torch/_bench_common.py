"""What the two benchmark programs (``bench.py``, ``bench_certify.py``) and
``chip_smoke.py`` share: the H100's published peaks and the bounds derived
from them, timing on the card (CUDA events, torch.profiler), the kernels'
launch counters, the plain path that replaces every kernel by its plain
PyTorch version, the card's name and power limit, and the check that a
caller who asked for the card has one.

Nothing here falls back to the CPU: a measurement that finds no card fails.
"""
from __future__ import annotations

import contextlib
import subprocess
import time
from unittest import mock

import torch

__all__ = ["FP32_FLOPS", "TF32_FLOPS", "HBM_BYTES", "bound_ms", "conv_bound",
           "rhs_flops", "rhs_bound", "cuda_ms", "kernel_ms",
           "range_names", "is_device_op", "device_breakdown", "counts", "reset_counts", "plain_freq_apply",
           "plain_rhs_vjp", "plain_path", "card", "require_cuda"]

# the H100 SXM's published peaks (NVIDIA data sheet, dense, 700 W): float32
# outside the tensor cores, TF32 on the tensor cores, HBM3; a kernel's bound
# is the larger of its bytes (each input read once, each output written
# once) over the memory rate and its flops over the peak rate of the unit
# that runs them: the products of K1 and K2 and K3's mix run on the tensor
# cores in 3xTF32, three TF32 products per float32 product; K1's and K2's
# bisection runs on float32 lanes
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


# each kernel wrapper's launch counter (utils/tracing.py) by the name these
# programs report it under
LAUNCH_COUNTERS = {"fused_rhs": "k1.launches",
                   "fused_rhs_backward": "k2.launches",
                   "fused_freq_apply": "k3.launches"}
_counted_from = dict.fromkeys(LAUNCH_COUNTERS.values(), 0)


def counts() -> dict:
    """Each kernel wrapper's launches since the last ``reset_counts()`` (or
    the process's start)."""
    from .utils.tracing import counters
    now = counters()
    return {k: now.get(c, 0) - _counted_from[c]
            for k, c in LAUNCH_COUNTERS.items()}


def reset_counts() -> None:
    from .utils.tracing import counters
    now = counters()
    _counted_from.update({c: now.get(c, 0) for c in _counted_from})


def plain_freq_apply(x, Qr, Qi):
    """fused_freq_apply by its plain version (the dense DFT, no K3)."""
    from .ops.cayley import apply_freq_matrices
    return apply_freq_matrices(x, torch.complex(Qr, Qi), impl="dft")


def plain_rhs_vjp(h, xc, g, p, *consts, weight_grads=True):
    """fused_rhs_vjp by its plain version (no K2)."""
    from .ops.fused_rhs import rhs_vjp_reference
    dh, dxc, dp = rhs_vjp_reference(h, xc, g, p, *consts)
    return dh, dxc, dp if weight_grads else None


@contextlib.contextmanager
def plain_path():
    """Run solves with K1 and K3 replaced by their plain versions; their
    backward is then autograd through the plain versions (no K2), and the
    adjoint's augmented RHS takes the plain versions of K1 and K2.  Raises
    if a kernel launched inside."""
    from .models import ivp, layers
    from .ops.fused_rhs import rhs_reference
    before = counts()
    with mock.patch.object(ivp, "fused_rhs", rhs_reference), \
            mock.patch.object(ivp, "fused_rhs_vjp", plain_rhs_vjp), \
            mock.patch.object(layers, "fused_freq_apply", plain_freq_apply):
        yield
    if counts() != before:
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


def require_cuda(device) -> torch.device:
    """``device`` as a torch.device; raises when it names CUDA and there is
    no card.  Nothing moves to the CPU unasked."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{device}: no CUDA device is available (ask for "
                           "device='cpu' to run on the CPU)")
    return device
