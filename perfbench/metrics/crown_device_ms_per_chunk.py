"""Device milliseconds of CROWN's bounds a chunk inside the window's own
blocks: the device intervals of the program's ``certify.crown`` spans
(``verify/certify.Certifier.crown_block`` around ``crown_mlp_bounds``)
in the profiled slice's blocks, over their number.  It shadows
``crown_ms_per_chunk``, which times the benchmark's own calls on the
grid's first chunk."""
from perfbench import spans


def read(ctx):
    recs = spans.named(ctx, "certify.crown_block", "certify.crown")
    return None if recs is None else spans.mean(r["device_ms"] for r in recs)
