"""The device's idle share of the profiled slice, in percent: 1 - the union
of the device operations' intervals over the slice's wall time
(torch.profiler)."""


def read(ctx):
    p = ctx.profile
    if p is None or p.busy_s() <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s() / p.window_s)
