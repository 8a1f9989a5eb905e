"""Share of the profiled slice's training steps that replayed the step's
CUDA graph: the ``train.step`` roots whose counter deltas hold
``train.graph_replays``, in percent (0 where the program replays no
graph).  None where the slice has not one root a step."""
from perfbench import spans


def read(ctx):
    tops = spans.roots(ctx, "train.step")
    if tops is None:
        return None
    return 100.0 * spans.mean(
        float(r["counters"].get("train.graph_replays", 0) > 0) for r in tops)
