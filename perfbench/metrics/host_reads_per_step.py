"""Host reads a training step: the CUDA runtime calls that make the host
wait for the device (``spans.WAITS``) inside each ``train.step`` host range
of the profiled slice, from any thread (autograd's backward included), the
mean over its steps (torch.profiler)."""
from perfbench import spans


def read(ctx):
    return spans.calls_inside(ctx, "train.step", spans.WAITS)
