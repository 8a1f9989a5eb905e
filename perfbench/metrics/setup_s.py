"""Seconds from the process's start to the window's start: imports, the
weights drawn on the card or read from a checkpoint, the kernels loaded
(built on a checkout's first run), the inputs, the warm-up of every shape
the window uses (host clock)."""


def read(ctx):
    return ctx.setup_s
