"""Rejected steps a solve: the delta of the ``odeint.rejected`` counter
inside each ``ivp.solve`` span of the profiled slice, the mean over its
solves."""
from perfbench import spans


def read(ctx):
    tops = spans.roots(ctx, "ivp.solve")
    if tops is None:
        return None
    return spans.mean(r["counters"].get("odeint.rejected", 0) for r in tops)
