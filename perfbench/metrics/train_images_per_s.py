"""Training images stepped in the window (B x optimizer steps), over the
window's seconds, until the device finished the last step (host clock)."""
from perfbench import harness


def read(ctx):
    w = ctx.state.window
    return harness.rate(w["items"], w["seconds"])
