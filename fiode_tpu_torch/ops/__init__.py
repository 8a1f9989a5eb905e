"""Tensor ops: cone projection, Cayley transforms, and the two kernels."""
from .power_iteration import conv_sigma_max, power_iteration_conv, power_iteration_dense
