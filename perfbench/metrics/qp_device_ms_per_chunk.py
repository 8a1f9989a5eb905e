"""Device milliseconds of the interval QP a chunk inside the window's own
blocks: the device intervals of the program's ``certify.qp`` spans
(``Certifier.crown_block`` around ``ibp_cbf_qp`` and ``worst_case_vdot``)
in the profiled slice's blocks, over their number.  It shadows
``qp_ms_per_chunk``."""
from perfbench import spans


def read(ctx):
    recs = spans.named(ctx, "certify.crown_block", "certify.qp")
    return None if recs is None else spans.mean(r["device_ms"] for r in recs)
