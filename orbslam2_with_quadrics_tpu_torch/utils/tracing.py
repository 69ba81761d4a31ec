"""Spans and counts inside the port, on the profiler's clock.

    with tracing.span("ba.step", dev) as sp:
        if sp:
            sp.count(rows=O, live_rows=valid.sum())
        ...

A span records its name, an id, its parent's id (the span open on the same
thread when it began), a trace id shared by every span under one root, its
host start and end (``time.time_ns()``: the Unix-epoch clock that
``torch.profiler`` stamps its CPU events with) and, where ``dev`` is a CUDA
device, a pair of timing events recorded on that device's current stream
at enter and exit. Counts are Python numbers or device tensors; a tensor is
read only by :func:`spans`, never while the span runs, so a span adds no
host read and never waits for the device.

Spans record while ``torch.profiler`` records (each then also opens a
``record_function`` of its name, so it lies on the trace's timeline) or
inside ``with collect() as out:``. Otherwise :func:`span` returns a shared
handle that does nothing and is false: one attribute test and one C call,
no event, no allocation, no lock.

Finished spans go to one store for the process, bounded at :data:`BOUND`
(later spans are dropped and counted by :func:`dropped`); threads may add
to it at once. A span name never starts with ``bench.`` or ``cuda``: the
benchmark's trace reader keeps those prefixes for its own spans and for
runtime calls.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time

import torch

BOUND = 65536


class _State:
    collecting = 0                    # open collect() blocks
    dropped = 0


_state = _State()
_store: list = []
_lock = threading.Lock()
_local = threading.local()
_ids = itertools.count(1)


class _Off:
    """The handle of a span that does not record."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self):
        return False

    def count(self, **counts):
        pass


_OFF = _Off()


class _Span:
    __slots__ = ("name", "dev", "id", "parent", "trace", "start_ns", "end_ns", "events",
                 "counts", "_rf")

    def __init__(self, name: str, dev):
        self.name, self.dev, self.counts = name, dev, {}

    def __bool__(self):
        return True

    def count(self, **counts):
        """Add counts: numbers, or tensors read when the spans are exported."""
        self.counts.update(counts)

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.id = next(_ids)
        self.parent = stack[-1].id if stack else None
        self.trace = stack[-1].trace if stack else self.id
        stack.append(self)
        self._rf = None
        if torch.autograd._profiler_enabled():
            self._rf = torch.profiler.record_function(self.name)
        self.start_ns = time.time_ns()    # the profiler's event lies inside the span
        if self._rf is not None:
            self._rf.__enter__()
        self.events = None
        if self.dev is not None and self.dev.type == "cuda":
            stream = torch.cuda.current_stream(self.dev)
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record(stream)
        return self

    def __exit__(self, *exc):
        if self.events is not None:
            self.events[1].record(torch.cuda.current_stream(self.dev))
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
        self.end_ns = time.time_ns()
        _local.stack.pop()
        with _lock:
            if len(_store) < BOUND:
                _store.append(self)
            else:
                _state.dropped += 1
        return False


def span(name: str, dev: torch.device | None = None):
    """A context manager timing its block as span ``name``; ``dev``: the
    device whose current stream the block's work is queued on."""
    if not (_state.collecting or torch.autograd._profiler_enabled()):
        return _OFF
    return _Span(name, dev)


def _value(v, done: bool):
    if torch.is_tensor(v):
        return (v.item() if v.numel() == 1 else v.tolist()) if done else None
    return v


def _export(s: _Span) -> dict:
    device_ms, done = None, True
    if s.events is not None:
        done = s.events[1].query()       # pending: no device time, no device count yet
        if done:
            device_ms = s.events[0].elapsed_time(s.events[1])
    return {"name": s.name, "id": s.id, "parent": s.parent, "trace": s.trace,
            "host_ms": (s.end_ns - s.start_ns) / 1e6, "device_ms": device_ms,
            "start_ns": s.start_ns, "end_ns": s.end_ns,
            "counts": {k: _value(v, done) for k, v in s.counts.items()}}


def spans() -> list:
    """The stored spans as plain dicts, in the order they ended: ``name``,
    ``id``, ``parent``, ``trace``, ``host_ms``, ``device_ms`` (None off the
    card, or while the span's work is still queued), ``start_ns``,
    ``end_ns`` and ``counts`` (tensors read as numbers). Leaves the store
    as it is."""
    with _lock:
        recs = list(_store)
    return [_export(s) for s in recs]


def dropped() -> int:
    """Spans left out since the last :func:`clear` because the store was full."""
    return _state.dropped


def clear():
    """Empty the store."""
    with _lock:
        _store.clear()
        _state.dropped = 0


@contextlib.contextmanager
def collect():
    """Record spans inside the block, the profiler on or not; yields a list
    that holds, once the block ends, the spans (as :func:`spans` gives
    them) recorded from its start. Starts from an empty store."""
    out: list = []
    clear()
    with _lock:
        _state.collecting += 1
    try:
        yield out
    finally:
        with _lock:
            _state.collecting -= 1
        out.extend(spans())
