"""Host milliseconds of the optimizer update a step: the mean host duration
(``time.perf_counter_ns``) of the program's ``train.optimizer`` spans
(``LyapunovTrainer._update``: Adam over every leaf) in the profiled
slice's steps."""
from perfbench import spans


def read(ctx):
    recs = spans.named(ctx, "train.step", "train.optimizer")
    if recs is None or len(recs) != ctx.profile.iterations:
        return None
    return spans.mean((r["t1_ns"] - r["t0_ns"]) / 1e6 for r in recs)
