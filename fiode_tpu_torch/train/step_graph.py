"""The Lyapunov train step replayed from one CUDA graph.

A step of ``LyapunovTrainer`` on the card is ~1,800 launches of small
kernels; issued one by one from the host they leave the device idle most of
the step.  ``StepGraph`` captures the trainer's own step body
(``LyapunovTrainer._step``: augment, backbone, sampler, ``eval_dot`` with
dropout, the Lyapunov loss, backward and the Adam update) once, and each
later step copies its inputs into the graph's buffers, writes the step's
kappa and learning rate into their device tensors and replays the graph:
one launch.  The mathematics is written once, in the eager body.

``step_route`` says, from what the trainer can observe, whether its steps
may replay: on CUDA, for the Lyapunov objective with Adam or AdamW, without
PGD (``adv_train``), the Lipschitz-aware kappa (``lips_train``), the
TrajectorySampler, a blended ODE loss (``ode_portion`` > 0) or a process
group.  Those contain solves or power iterations that read the device from
the host, or an ``all_reduce``; they run eager, as every CPU step does.

A graph holds for one ``graph_key`` (the shapes of the batch and its
draws, the sampler's slot counts, ``scale_nominal``, ``barrier_loss`` and
the conv apply the backbone calls, K3 or a plain stand-in) and for the
tensors it captured: the parameters, their gradients, the optimizer and
its state, and the dropout generator.  The trainer drops it when any of
them changes (a new optimizer, a loaded optimizer state, a mixer that
moves the slot counts).

What a replay keeps of the eager step: the dropout masks are drawn from
the trainer's generator, registered with the graph, in the eager order (a
seed or state set between replays holds); Adam's step count lives on the
device (``capturable``); each step returns its own loss and metrics
(copies, not the graph's buffers); after a replay every ``.grad`` and the
optimizer's state hold that step's values; the launch counters
(``k3.launches``) grow by what the capture counted, and
``train.graph_replays`` / ``train.graph_captures`` count replays and
captures (``utils/tracing.py``).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..models import layers
from ..utils.tracing import count, counters, span
from .samplers import slot_counts

__all__ = ["GRAPH_OPTIMIZERS", "step_route", "graph_key", "capturing",
           "StepGraph"]

GRAPH_OPTIMIZERS = ("Adam", "AdamW")


def step_route(device_type: str, cfg, *, ode_portion: float = 0.0,
               shard: Optional[tuple] = None) -> str:
    """"graph" where a train step of the configuration ``cfg`` on a device
    of ``device_type`` may replay from a CUDA graph, else "eager"."""
    graph = (device_type == "cuda" and cfg.objective == "lyapunov"
             and cfg.opt_name in GRAPH_OPTIMIZERS
             and not cfg.adv_train and not cfg.lips_train
             and "TrajectorySampler" not in cfg.sampler_names
             and ode_portion == 0 and shard is None)
    return "graph" if graph else "eager"


def capturing() -> bool:
    """Whether the current CUDA stream is being captured into a graph."""
    return (torch.cuda.is_initialized()
            and torch.cuda.is_current_stream_capturing())


def _leaves(tree) -> list:
    """The tensors of nested dicts, lists and tuples, in a fixed order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return []


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone(v) for v in tree)
    return tree


def graph_key(trainer, x, y, mixer, scale_nominal: bool, draws: dict) -> tuple:
    """What a captured step bakes in besides its tensors."""
    return ((tuple(x.shape), x.dtype, tuple(y.shape), y.dtype),
            tuple((tuple(t.shape), t.dtype) for t in _leaves(draws)),
            tuple(draws), tuple(int(c) for c in slot_counts(
                mixer, trainer.cfg.h_sample_size)),
            bool(scale_nominal), trainer.cfg.barrier_loss,
            layers.fused_freq_apply)


def _held(trainer) -> list:
    """The objects a capture reads and writes through: the generator, the
    optimizer, every parameter and its gradient, each group's learning
    rate and the optimizer's state tensors."""
    opt = trainer.opt
    held = [trainer.gen, opt]
    for p in trainer.model.parameters():
        held += [p, p.grad]
    for group in opt.param_groups:
        held.append(group["lr"])
        for p in group["params"]:
            held += list(opt.state.get(p, {}).values())
    return held


class StepGraph:
    """One train step captured for ``key``; ``replay`` runs the next."""

    @staticmethod
    def ready(trainer) -> bool:
        """Whether the optimizer can be captured: capturable, its learning
        rates device tensors, its state made by an eager step."""
        opt = trainer.opt
        return all(g.get("capturable") and isinstance(g["lr"], torch.Tensor)
                   and all(p in opt.state for p in g["params"])
                   for g in opt.param_groups)

    def __init__(self, trainer, key: tuple, x, y, kappa: float, mixer,
                 scale_nominal: bool, draws: dict):
        self.key = key
        self.x, self.y, self.draws = x.clone(), y.clone(), _clone(draws)
        self.kappa = torch.full((), kappa, dtype=torch.float32,
                                device=trainer.device)
        self.graph = torch.cuda.CUDAGraph()
        self.graph.register_generator_state(trainer.gen)
        before, opt_count = counters(), trainer.opt_count
        with torch.cuda.graph(self.graph):
            loss, metrics = trainer._step(self.x, self.y, None, mixer, 0.0,
                                          scale_nominal, self.draws,
                                          kappa=self.kappa)
            self.names = list(metrics)
            self.out = torch.stack([loss] + [metrics[k] for k in self.names])
        # the capture launched nothing: its counts are the replays'
        self.launches = {k: v - before.get(k, 0) for k, v in counters().items()
                         if v != before.get(k, 0)}
        for k, v in self.launches.items():
            count(k, -v)
        trainer.opt_count = opt_count
        self.held = _held(trainer)
        count("train.graph_captures")

    def holds(self, trainer) -> bool:
        """Whether every object the capture read is still the trainer's."""
        now = _held(trainer)
        return len(now) == len(self.held) and all(
            a is b for a, b in zip(now, self.held))

    def replay(self, trainer, x, y, kappa: float, draws: dict):
        """The step on (x, y, draws) at ``kappa``; returns (loss, metrics),
        this step's own device tensors."""
        self.x.copy_(x)
        self.y.copy_(y)
        for mine, theirs in zip(_leaves(self.draws), _leaves(draws)):
            mine.copy_(theirs)
        self.kappa.fill_(kappa)
        with span("train.optimizer"):
            trainer._set_lr()
            trainer.opt_count += 1
        self.graph.replay()
        for k, v in self.launches.items():
            count(k, v)
        count("train.graph_replays")
        out = self.out.clone()
        return out[0], dict(zip(self.names, out[1:]))
