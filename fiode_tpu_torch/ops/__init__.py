"""Tensor ops: cone projection, Cayley transforms, and the two kernels."""
