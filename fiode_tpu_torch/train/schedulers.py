"""Per-epoch sampler-mixing schedulers (counterpart of
``fiode_tpu/train/schedulers.py``; host-side, pure Python).

The composite scheduler's L1-normalised coefficient vector is computed on
the host at the start of each epoch and decides how many of the S sample
slots each sampler owns (``samplers.composite_sample``).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

__all__ = [
    "LinearScheduler",
    "ConstantScheduler",
    "SwitchScheduler",
    "CompositeSamplerScheduler",
]


@dataclasses.dataclass
class LinearScheduler:
    rate: float
    bias: float = 0.0
    clamp: str = "min"  # 'min' | 'max' | other -> unclamped
    clamp_val: float = 0.0
    start: int = 0

    def __post_init__(self):
        if self.clamp_val < 0:
            raise ValueError("schedulers must return positive numbers")

    def sampler_weight(self, epoch: int) -> float:
        if epoch < self.start:
            return 0.0 if self.rate > 0 else 1.0
        w = (epoch - self.start) * self.rate + self.bias
        if self.clamp == "max":
            return min(w, self.clamp_val)
        if self.clamp == "min":
            return max(w, self.clamp_val)
        return w


@dataclasses.dataclass
class ConstantScheduler:
    constant: float = 1.0

    def __post_init__(self):
        if self.constant < 0:
            raise ValueError("schedulers must return positive numbers")

    def sampler_weight(self, epoch: int) -> float:
        return self.constant


@dataclasses.dataclass
class SwitchScheduler:
    start: float
    end: float
    trigger: float

    def __post_init__(self):
        if self.start < 0 or self.end < 0:
            raise ValueError("schedulers must return positive numbers")

    def sampler_weight(self, epoch: int) -> float:
        return self.start if epoch < self.trigger else self.end


@dataclasses.dataclass
class CompositeSamplerScheduler:
    schedulers: Sequence
    scheduler_weights: Sequence[float]

    def __post_init__(self):
        if len(self.schedulers) != len(self.scheduler_weights):
            raise ValueError("one weight per scheduler")

    def get_mixer_coefficients(self, epoch: int) -> np.ndarray:
        raw = np.array([s.sampler_weight(epoch) for s in self.schedulers])
        w = raw * np.asarray(self.scheduler_weights)
        return w / (np.abs(w).sum() + 1e-12)
