"""Device allocations a solve: the cudaMalloc calls inside each
``ivp.solve`` host range of the profiled slice, the mean over its solves
(torch.profiler).  They count the caching allocator's and the libraries'
own (the batched LU's) alike."""
from perfbench import spans


def read(ctx):
    return spans.calls_inside(ctx, "ivp.solve", ("cudaMalloc",))
