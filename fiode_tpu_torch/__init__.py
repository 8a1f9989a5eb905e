"""PyTorch / CUDA port of fiode_tpu's flagship forward solve, the
gradients through it, and the AutoAttack suite run on it.

Mirrors ``fiode_tpu`` module for module (``ops/``, ``models/``, ``ode/``,
``attacks/``, ``experiment.py``).
The JAX package is the reference; this package imports only torch and
numpy.  On a CPU tensor every kernel wrapper runs its plain PyTorch
version; on a CUDA tensor it launches the hand-written Hopper kernel built
from ``csrc/`` (see ``ops/_build.py``).
"""
from .bridge import params_from_numpy
from .entry import entry, flagship
from .models.ivp import NeuralODEClassifier

__all__ = ["NeuralODEClassifier", "entry", "flagship", "params_from_numpy"]
