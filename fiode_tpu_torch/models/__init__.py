"""Layers, dynamics, backbones and the neural-ODE classifier."""
