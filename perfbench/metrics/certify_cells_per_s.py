"""Images x grid cells bounded in the window's whole sweeps of the grid,
over the window's seconds, each block ended by its host read of the worst
values (host clock)."""
from perfbench import harness


def read(ctx):
    w = ctx.state.window
    return harness.rate(w["items"], w["seconds"])
