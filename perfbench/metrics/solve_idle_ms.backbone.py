"""Device-idle milliseconds a solve inside the backbone: the profiled
slice's idle gaps whose midpoint lies inside an ``ivp.backbone`` host range
(at any depth: the Cayley transforms' ``cayley`` spans count), summed over
the slice's solves (torch.profiler)."""
from perfbench import spans


def read(ctx):
    p = ctx.profile
    if p is None or sum(h[0] == "ivp.backbone" for h in p.host_ops) \
            != p.iterations:
        return None
    return spans.idle_ms_inside(ctx, lambda n: n == "ivp.backbone",
                                "ivp.solve")
