"""Certification: the decision-boundary grid, CROWN / IBP bounds, the
interval QP, the ``Certifier`` and branch-and-bound refinement."""
from .refine import RefineStats, SweepStats, hybrid_base_sweep, refine_uncertified
from .refine_lips import refine_lips_uncertified

__all__ = ["refine_uncertified", "RefineStats", "hybrid_base_sweep",
           "SweepStats", "refine_lips_uncertified"]
