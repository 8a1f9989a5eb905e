"""Adaptive ODE integration (dopri5)."""
