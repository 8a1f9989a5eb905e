"""The 95th percentile, by nearest rank, of every solve of the window, each
timed from its issue until its endpoints are synchronised (host clock)."""
from perfbench import harness


def read(ctx):
    return harness.p95(ctx.state.window["ms"])
