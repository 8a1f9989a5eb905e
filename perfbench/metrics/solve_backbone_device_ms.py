"""Device milliseconds of the backbone inside the solve: the mean, over the
profiled slice's solves, of the device interval of the program's
``ivp.backbone`` span (``models/ivp.NeuralODEClassifier.solve`` around
``features``; CUDA events on the current stream).  It shadows
``backbone_ms``, which times the benchmark's own calls apart from the
window."""
from perfbench import spans


def read(ctx):
    recs = spans.named(ctx, "ivp.solve", "ivp.backbone")
    if recs is None or len(recs) != ctx.profile.iterations:
        return None
    return spans.mean(r["device_ms"] for r in recs)
