"""The port's spans and counters.

  * ``span(name)``: a context manager around one piece of work.  With
    tracing off it is one check that returns a shared null context: no
    profiler range, no clock read, no allocation.  With tracing on it
    enters ``torch.profiler.record_function(name)``, so the span sits in a
    profiler's host timeline beside the device operations, and keeps a
    record: ``id``, ``parent`` (None for a root), ``root`` (the id of the
    root span it belongs to: one solve, block or step), ``name``, host
    ``t0_ns`` / ``t1_ns`` (``time.perf_counter_ns``), ``device_ms``
    (between two CUDA timing events on the current stream, where CUDA is
    initialised and the stream is not under CUDA-graph capture; None
    otherwise) and ``counters``, the deltas of every counter inside the
    span.
  * ``count(name, n=1)``: adds n to one process-wide counter, always on;
    ``counters()`` returns a copy of them all.

Tracing is on while a torch profiler is active or after ``enable()``.
Spans nest by the order they open in the process: the port opens them
from one thread at a time (autograd's device threads run while the caller
waits in ``backward``).  The records sit in a bounded buffer
(``MAX_RECORDS``; the oldest is dropped, and counted as
``tracing.dropped``).  ``records()`` reads it without clearing it,
waiting for the device where a record's end event is still pending;
``clear()`` empties it.  ``utils/debug.trace`` writes a body's records
as ``spans.jsonl`` beside its Chrome trace.

Counter names: ``k1.launches`` to ``k5.launches`` (the kernel wrappers),
``odeint.rejected`` (the adaptive solver's rejected steps) and
``train.graph_captures`` / ``train.graph_replays`` (the train step's CUDA
graph, ``train/step_graph.py``).  A replayed graph adds the launch
deltas its capture counted, so the launch counters keep counting kernels
launched.  What a span waits for on the device (its synchronising CUDA
calls) and allocates there is read from a profiler's trace of it, not
counted here: that sees the libraries' own calls too.
"""
from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Optional

import torch
from torch.autograd import _profiler_enabled

__all__ = ["MAX_RECORDS", "span", "count", "counters", "records", "clear",
           "enable", "disable", "next_id"]

MAX_RECORDS = 65536

_OFF = contextlib.nullcontext()
_lock = threading.Lock()
_counters: dict = {}
_records: collections.deque = collections.deque()
_stack: list = []   # the open spans' records, outermost first
_events: list = []  # CUDA timing events free for reuse
_state = {"on": False, "next_id": 1}


def enable() -> None:
    """Trace from now on, with or without a profiler."""
    _state["on"] = True


def disable() -> None:
    """Trace only while a torch profiler is active."""
    _state["on"] = False


def count(name: str, n: int = 1) -> None:
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def counters() -> dict:
    with _lock:
        return dict(_counters)


def next_id() -> int:
    """The id the next span will take: ``records(since=next_id())`` later
    reads the spans opened in between."""
    return _state["next_id"]


def span(name: str):
    if not (_state["on"] or _profiler_enabled()):
        return _OFF
    return _Span(name)


def _event() -> torch.cuda.Event:
    return _events.pop() if _events else torch.cuda.Event(enable_timing=True)


class _Span:
    __slots__ = ("name", "rec", "range", "before", "ev")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        parent = _stack[-1] if _stack else None
        rid = _state["next_id"]
        _state["next_id"] = rid + 1
        self.rec = {"id": rid,
                    "parent": None if parent is None else parent["id"],
                    "root": rid if parent is None else parent["root"],
                    "name": self.name}
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        self.before = counters()
        self.ev = None
        if (torch.cuda.is_initialized()
                and not torch.cuda.is_current_stream_capturing()):
            self.ev = (_event(), _event())
            self.ev[0].record()
        _stack.append(self.rec)
        self.rec["t0_ns"] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        rec = self.rec
        rec["t1_ns"] = time.perf_counter_ns()
        if self.ev is not None:
            self.ev[1].record()
        _stack.pop()
        now = counters()
        rec["counters"] = {k: v - self.before.get(k, 0) for k, v in now.items()
                           if v != self.before.get(k, 0)}
        rec["device_ms"] = None
        rec["_ev"] = self.ev
        self.range.__exit__(*exc)
        if len(_records) >= MAX_RECORDS:
            dropped = _records.popleft()
            if dropped["_ev"] is not None:
                _events.extend(dropped["_ev"])
            count("tracing.dropped")
        _records.append(rec)
        return False


def records(since: Optional[int] = None) -> list:
    """Copies of the buffer's records (those with ``id >= since`` when
    given), in the order their spans closed."""
    out = []
    for rec in _records:
        if since is not None and rec["id"] < since:
            continue
        ev = rec["_ev"]
        if ev is not None:
            ev[1].synchronize()
            rec["device_ms"] = ev[0].elapsed_time(ev[1])
            rec["_ev"] = None
            _events.extend(ev)
        out.append({k: v for k, v in rec.items() if k != "_ev"})
    return out


def clear() -> None:
    """Empty the record buffer (the counters stay)."""
    for rec in _records:
        if rec["_ev"] is not None:
            _events.extend(rec["_ev"])
    _records.clear()
