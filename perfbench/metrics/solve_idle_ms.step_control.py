"""Device-idle milliseconds a solve inside the step control: the profiled
slice's idle gaps whose midpoint lies inside any ``odeint.*`` host range
(``odeint.first_step``, ``odeint.attempt``, ``odeint.host_read``: the
RHS's launches, the error ratio and the host's read that decides each
step), over the slice's solves (torch.profiler)."""
from perfbench import spans


def read(ctx):
    return spans.idle_ms_inside(ctx, lambda n: n.startswith("odeint."),
                                "ivp.solve")
