"""Model constructors: the flagship (counterpart of ``__graft_entry__._flagship``
and ``entry``), KWLarge Cayley backbone with GroupSort -> simplex neural-ODE
classifier, dopri5 at rtol = atol = 1e-3 to t = 1; and the certified
configuration (counterpart of ``fiode_tpu.experiment.build_model`` on
``configs/certify/cifar_certify.yaml``), which the attacks run against."""
from __future__ import annotations

from typing import Optional

import torch

from .models.backbones import KWLargeBackbone
from .models.dynamics import SimplexDynamics
from .models.ivp import NeuralODEClassifier

__all__ = ["flagship", "certify_model", "entry", "CIFAR_MU", "CIFAR_STD"]

CIFAR_MU = (0.485, 0.456, 0.406)
CIFAR_STD = (0.225, 0.225, 0.225)


def flagship(n_classes: int = 10, mlp_size: int = 128,
             generator: Optional[torch.Generator] = None,
             device: str = "cuda") -> NeuralODEClassifier:
    """The flagship classifier in eval mode on ``device``.  Its weights are
    drawn from ``generator`` on the CPU and then moved, so a seed gives the
    same weights on every device."""
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
    return model.eval().to(device)


def certify_model(t_max: float = 1.0, max_steps: int = 64,
                  generator: Optional[torch.Generator] = None,
                  device: str = "cuda") -> NeuralODEClassifier:
    """The cifar_certify configuration: KWLarge GroupSort backbone to 10
    features, ReLU simplex dynamics (mlp 128, alpha_1 = 100, sigma_1 = 0.02,
    alpha_2 = 20, scale_nominal off), dopri5 at rtol = atol = 1e-3 to
    ``t_max`` within ``max_steps`` attempted steps.  In eval mode on
    ``device``, weights drawn from ``generator`` on the CPU, then moved."""
    dyn = SimplexDynamics(
        n_hidden=10, mlp_size=128, x_dim=10, activation="ReLU", dropout=0.5,
        alpha_1=100.0, alpha_2=20.0, sigma_1=0.02, scale_nominal=False,
        generator=generator,
    )
    backbone = KWLargeBackbone(out_dim=10, act="GroupSort", mu=CIFAR_MU,
                               std=CIFAR_STD, generator=generator)
    model = NeuralODEClassifier(
        backbone=backbone, dynamics=dyn, t_max=t_max, rtol=1e-3, atol=1e-3,
        max_steps=max_steps,
    )
    return model.eval().to(device)


def entry(device: str = "cuda"):
    """(fn, example_args): the flagship's forward pass on 8 blank images on
    ``device``, weights from seed 0."""
    model = flagship(generator=torch.Generator().manual_seed(0), device=device)
    x = torch.zeros((8, 3, 32, 32), device=device)
    return model.predict, (x,)
