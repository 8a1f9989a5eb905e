"""What the readers of the program's own spans and counters share
(``fiode_tpu_torch/utils/tracing.py``): the records of the profiled slice,
its roots (one solve, CROWN block or train step each), means over them,
the slice's idle gaps inside the host ranges the spans left in the
profile, and the CUDA runtime calls the profile saw inside those ranges.
The program traces only while a profiler runs, so in a run of the
benchmark its records are the slice's.  Each function returns None
where the program keeps no such records (it has no tracing module, or the
run was not traced), or where the slice's roots are not one per
iteration."""
from __future__ import annotations

__all__ = ["WAITS", "records", "roots", "named", "mean", "idle_gaps",
           "idle_ms_inside", "calls_inside"]

# the CUDA runtime calls that make the host wait for the device: every read
# of a device value or blocking copy PyTorch makes ends in the first; the
# libraries' own (the batched LU's) add the second
WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpy")


def records(ctx):
    """The program's span records, or None."""
    if ctx.profile is None:
        return None
    try:
        from fiode_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing.records()


def roots(ctx, name: str):
    """The slice's root records called ``name``, or None unless there is
    one an iteration."""
    recs = records(ctx)
    if recs is None:
        return None
    found = [r for r in recs if r["name"] == name and r["parent"] is None]
    return found if len(found) == ctx.profile.iterations else None


def named(ctx, root: str, name: str):
    """The records called ``name`` under the slice's roots called ``root``,
    or None where the roots are not one an iteration or there is no such
    record."""
    tops = roots(ctx, root)
    if tops is None:
        return None
    ids = {r["id"] for r in tops}
    found = [r for r in records(ctx) if r["name"] == name and r["root"] in ids]
    return found or None


def mean(values):
    values = list(values)
    if not values or any(v is None for v in values):
        return None
    return sum(values) / len(values)


def idle_gaps(profile) -> list:
    """The slice's idle gaps as (start, end) in microseconds: where no
    device operation runs (as ``harness.Profile.breakdown`` finds them)."""
    busy = profile.busy_intervals()
    edges = ([profile.start_us] + [x for iv in busy for x in iv]
             + [profile.end_us])
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]


def idle_ms_inside(ctx, inside, root: str):
    """Device-idle milliseconds an iteration in the slice's gaps whose
    midpoint lies inside a host range ``inside(name)`` accepts (at any
    depth), or None where the profile has not one ``root`` range an
    iteration, no such range or no device operation."""
    p = ctx.profile
    if p is None or not p.device_ops:
        return None
    if sum(h[0] == root for h in p.host_ops) != p.iterations:
        return None
    ranges = [(h[1], h[2]) for h in p.host_ops if inside(h[0])]
    if not ranges:
        return None
    total = 0.0
    for s, e in idle_gaps(p):
        mid = 0.5 * (s + e)
        if any(a <= mid <= b for a, b in ranges):
            total += e - s
    return total / 1e3 / p.iterations


def calls_inside(ctx, root: str, names):
    """CUDA runtime calls named in ``names`` a ``root`` range: those of the
    profile's host calls (any thread) that start inside each of the
    slice's ``root`` host ranges, the mean over the ranges; None where the
    profile has no device operation or not one ``root`` range an
    iteration."""
    p = ctx.profile
    if p is None or not p.device_ops:
        return None
    tops = [(h[1], h[2]) for h in p.host_ops if h[0] == root]
    if len(tops) != p.iterations:
        return None
    calls = [h[1] for h in p.host_ops if h[0] in names]
    return mean(sum(a <= t <= b for t in calls) for a, b in tops)
