"""Inputs that the benchmark makes itself from a mix's parameters.

``synthetic_test_set`` remakes the program's synthetic CIFAR-shaped test
set (per-class prototypes uniform in [0.2, 0.8), each image its class's
prototype plus gaussian noise, clipped to [0, 1]), the set on which the
repo's trained checkpoint was certified when no CIFAR files are at hand.
It is a copy of the test split of ``fiode_tpu_torch.train.data._synthetic``
at hardness 0, held to it by a CPU test, so that the inputs pass through no
code under test.
"""
from __future__ import annotations

import numpy as np

__all__ = ["synthetic_test_set"]


def synthetic_test_set(seed: int, size: int, classes: int, channels: int,
                       side: int, noise: float):
    """(images (size, channels, side, side) float32 in [0, 1], labels
    (size,) int32) of the synthetic test set made from ``seed``."""
    protos = np.random.default_rng(seed).uniform(
        0.2, 0.8, size=(classes, channels, side, side)).astype(np.float32)
    r = np.random.default_rng(seed + 2)
    labels = r.integers(0, classes, size=size).astype(np.int32)
    images = protos[labels] + noise * r.standard_normal(
        (size, channels, side, side)).astype(np.float32)
    return np.clip(images, 0.0, 1.0), labels
