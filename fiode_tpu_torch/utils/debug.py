"""Debug and profiling switches (counterpart of ``fiode_tpu/utils/debug.py``).

  * ``set_debug(nans=True, infs=True)``: raise at the first non-finite
    value, in the forward (a global module forward hook checks every
    module's tensor outputs) and in the backward
    (``torch.autograd.set_detect_anomaly``, which names the forward op
    whose gradient went NaN);
  * ``trace(log_dir)``: a ``torch.profiler`` trace of the body, CPU and
    (on a CUDA machine) device activity, written as a Chrome trace
    (``<host>_<pid>.<time>.pt.trace.json``) that TensorBoard's profiler
    plugin reads, and the body's span records (``utils/tracing.py``) as
    ``spans.jsonl`` beside it, one JSON object a line;
  * ``step_timer(name)``: a section timer that synchronises the CUDA
    device at both ends, so its time is the work's and not the launches'.

``set_debug(checks=True)`` stays unsupported: the JAX package's
``jax_numpy_rank_promotion="raise"`` has no PyTorch counterpart.  The JAX
module's ``env_flag`` stays behind with the ``FIODE_*`` gates it parsed.
"""
from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path
from typing import Iterator

import torch

from . import tracing

__all__ = ["set_debug", "trace", "step_timer", "NonFiniteError"]


class NonFiniteError(FloatingPointError):
    """A module's forward produced a NaN or an infinity."""


_state = {"hook": None}


def _check_outputs(nans: bool, infs: bool):
    def check(t, module):
        if not (isinstance(t, torch.Tensor) and t.is_floating_point()):
            return
        if nans and torch.isnan(t).any():
            raise NonFiniteError(f"NaN in the output of {type(module).__name__}")
        if infs and torch.isinf(t).any():
            raise NonFiniteError(f"inf in the output of {type(module).__name__}")

    def hook(module, args, output):
        outs = output if isinstance(output, (tuple, list)) else (output,)
        for t in outs:
            check(t, module)

    return hook


def set_debug(nans: bool = False, infs: bool = False, checks: bool = False):
    """Turn the non-finite checks on or off for every ``nn.Module`` forward
    and every backward of this process.  Each check costs a device read per
    module output."""
    if checks:
        raise NotImplementedError(
            "checks=True: rank-promotion checking (jax_numpy_rank_promotion) "
            "has no PyTorch counterpart")
    if _state["hook"] is not None:
        _state["hook"].remove()
        _state["hook"] = None
    if nans or infs:
        _state["hook"] = torch.nn.modules.module.register_module_forward_hook(
            _check_outputs(nans, infs))
    torch.autograd.set_detect_anomaly(bool(nans or infs), check_nan=bool(nans))


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the body into a ``*.pt.trace.json`` under ``log_dir`` and
    its span records into ``log_dir/spans.jsonl``; yields the profiler
    (``key_averages()`` after the body)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    prof = torch.profiler.profile(activities=activities, record_shapes=True)
    first = tracing.next_id()
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        torch.profiler.tensorboard_trace_handler(str(log_dir))(prof)
        with open(Path(log_dir) / "spans.jsonl", "w") as f:
            for rec in tracing.records(since=first):
                f.write(json.dumps(rec) + "\n")


@contextlib.contextmanager
def step_timer(name: str, sink=None) -> Iterator[None]:
    """Time the body on the host clock, synchronising the current CUDA
    device (when CUDA is in use) at both ends; print the milliseconds, or
    call ``sink(name, seconds)``."""
    def wait():
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()

    wait()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        wait()
        dt = time.perf_counter() - t0
        if sink is None:
            print(f"[timer] {name}: {dt * 1000:.1f}ms", flush=True)
        else:
            sink(name, dt)
