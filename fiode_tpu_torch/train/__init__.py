"""Data, samplers, the Lyapunov loss and the trainer."""
