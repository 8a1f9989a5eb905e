"""Multi-process data-parallel training with ``torch.distributed``
(counterpart of ``fiode_tpu/parallel/multihost.py``).

Every process runs the same program on its own device.  The input pipeline
is deterministic and replicated: every process composes the same config,
loads or synthesises the same dataset, shuffles with the same seeded
generator and makes the same random draws for the whole global batch (crop
offsets and flips, sampler draws, dropout masks, PGD starts), then keeps
its own rows of each (``process_rows``, ``shard_rows``).  No data crosses
between processes; the gradients are mean-reduced before every optimizer
update (``LyapunovTrainer``), so the update equals the one-process update
on the global batch up to the rounding of the reduction.

    python -m torch.distributed.run --standalone --nproc_per_node=N \\
        -m fiode_tpu_torch train --multihost ...

``torch.distributed.run`` sets ``MASTER_ADDR``, ``MASTER_PORT``,
``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK``; ``bootstrap_multihost`` reads
them.  Without them a ``--multihost`` command runs as one process.
"""
from __future__ import annotations

import os
from typing import Any, Callable, Optional, Tuple

import torch
import torch.distributed as dist

__all__ = ["bootstrap_multihost", "shutdown_multihost", "is_multihost",
           "process_rows", "rank_and_size", "shard_rows", "local_device",
           "all_reduce_sum"]

_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")


def local_device(device="cuda") -> torch.device:
    """The device this process trains on: ``cuda:LOCAL_RANK`` for a CUDA
    ``device`` under ``torch.distributed.run``, else ``device`` itself."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None \
            and "LOCAL_RANK" in os.environ:
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    return device


def bootstrap_multihost(device="cuda") -> Tuple[int, int]:
    """Join the process group that ``torch.distributed.run`` describes in
    the environment; returns (rank, world_size).

    NCCL on a CUDA ``device`` (which binds ``cuda:LOCAL_RANK`` as this
    process's current device), gloo on the CPU.  Without the variables it
    initialises nothing and returns (0, 1).
    """
    if not all(k in os.environ for k in _ENV):
        return 0, 1
    dev = local_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(
            backend="nccl" if dev.type == "cuda" else "gloo",
            init_method="env://", world_size=int(os.environ["WORLD_SIZE"]),
            rank=int(os.environ["RANK"]))
    return dist.get_rank(), dist.get_world_size()


def shutdown_multihost() -> None:
    """Leave the process group, if one is initialised."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def rank_and_size() -> Tuple[int, int]:
    """(rank, world size) of the initialised process group, else (0, 1)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_multihost() -> bool:
    return rank_and_size()[1] > 1


def process_rows(n_rows: int, axis_size: Optional[int] = None) -> slice:
    """This process's contiguous rows [i n/p, (i+1) n/p) of a global batch
    of ``n_rows`` that every process holds in the same order; ``n_rows``
    must divide by the number of processes."""
    i, p = rank_and_size()
    if axis_size is not None:
        p = axis_size
    if n_rows % p:
        raise ValueError(f"global batch {n_rows} not divisible by {p} processes")
    per = n_rows // p
    return slice(i * per, (i + 1) * per)


def shard_rows(draw: Callable[[int], Any], n_local: int,
               shard: Optional[Tuple[int, int]]):
    """A random draw of ``n_local`` leading rows for the part ``shard`` =
    (index, count) of a global batch: ``draw(count n_local)``'s rows
    [index n_local, (index + 1) n_local) (of each tensor, when ``draw``
    returns a tuple), so every process consumes the generator as one
    process drawing for the whole batch would.  With ``shard`` None,
    ``draw(n_local)``."""
    if shard is None:
        return draw(n_local)
    i, p = shard
    out = draw(p * n_local)
    rows = slice(i * n_local, (i + 1) * n_local)
    return tuple(t[rows] for t in out) if isinstance(out, tuple) else out[rows]


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``t`` over the processes of ``group``, differentiable: the
    gradient of every process's input is the sum of the processes' output
    gradients (each process's loss depends on every input)."""
    return _AllReduceSum.apply(t, group)
