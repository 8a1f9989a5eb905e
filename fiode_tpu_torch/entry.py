"""The flagship model (counterpart of ``__graft_entry__._flagship`` and
``entry``): KWLarge Cayley backbone with GroupSort -> simplex neural-ODE
classifier, dopri5 at rtol = atol = 1e-3 to t = 1."""
from __future__ import annotations

from typing import Optional

import torch

from .models.backbones import KWLargeBackbone
from .models.dynamics import SimplexDynamics
from .models.ivp import NeuralODEClassifier

__all__ = ["flagship", "entry", "CIFAR_MU", "CIFAR_STD"]

CIFAR_MU = (0.485, 0.456, 0.406)
CIFAR_STD = (0.225, 0.225, 0.225)


def flagship(n_classes: int = 10, mlp_size: int = 128,
             generator: Optional[torch.Generator] = None
             ) -> NeuralODEClassifier:
    """The flagship classifier, weights drawn from ``generator`` on the CPU
    and in eval mode (move it with ``.to(device)``)."""
    dyn = SimplexDynamics(
        n_hidden=n_classes, mlp_size=mlp_size, x_dim=n_classes, dropout=0.5,
        alpha_1=100.0, alpha_2=20.0, sigma_1=0.02,
        scale_nominal=True, generator=generator,
    )
    backbone = KWLargeBackbone(out_dim=n_classes, act="GroupSort",
                               mu=CIFAR_MU, std=CIFAR_STD,
                               generator=generator)
    model = NeuralODEClassifier(
        backbone=backbone, dynamics=dyn, t_max=1.0,
        rtol=1e-3, atol=1e-3,
    )
    return model.eval()


def entry(device: str = "cpu"):
    """(fn, example_args): the flagship's forward pass on 8 blank images,
    weights from seed 0."""
    model = flagship(generator=torch.Generator().manual_seed(0))
    model = model.to(device)
    x = torch.zeros((8, 3, 32, 32), device=device)
    return model.predict, (x,)
