"""Milliseconds of the CROWN bounds (verify/crown.crown_mlp_bounds) on one
chunk of the window's rows (images x chunk cells, TF32 off), between CUDA
events around the benchmark's own calls."""


def read(ctx):
    chunk_ms = getattr(ctx.state, "chunk_ms", None)
    return None if chunk_ms is None else chunk_ms("crown")
