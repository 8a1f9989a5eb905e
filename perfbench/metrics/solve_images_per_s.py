"""Images whose forward solve finished in the window, over the window's
seconds, from the first solve's issue to the last one's end (host clock)."""
from perfbench import harness


def read(ctx):
    w = ctx.state.window
    return harness.rate(w["items"], w["seconds"])
