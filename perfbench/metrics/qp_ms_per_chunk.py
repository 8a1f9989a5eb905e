"""Milliseconds of the interval QP (verify/ibp_qp.ibp_cbf_qp) on one chunk
of the window's rows (images x chunk cells, on CROWN's bounds of that
chunk), between CUDA events around the benchmark's own calls."""


def read(ctx):
    chunk_ms = getattr(ctx.state, "chunk_ms", None)
    return None if chunk_ms is None else chunk_ms("qp")
