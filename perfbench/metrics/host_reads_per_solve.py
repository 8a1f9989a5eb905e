"""Host reads a solve: the CUDA runtime calls that make the host wait for
the device (``spans.WAITS``) inside each ``ivp.solve`` host range of the
profiled slice, the mean over its solves (torch.profiler).  They are the
Cayley transforms' solves, the step control's read of each attempt, the
uploads of the tableau and of ``ts``, and the batched LU's own waits."""
from perfbench import spans


def read(ctx):
    return spans.calls_inside(ctx, "ivp.solve", spans.WAITS)
