"""The port's spans and counters: what the host was doing, by layer.

``span(name)`` (or the decorator ``spanned(name)``) marks a host call at a
layer boundary (a training call, a window's replay, a guard's sync, the
feed's wait, a served batch); ``count(name)`` counts an event there. Both record only while a
``torch.profiler`` session runs: tracing is on exactly then, and no flag
of the port turns it on. With tracing off, ``span`` returns one shared
no-op context, at the cost of one flag read.

With tracing on, a span

- enters ``torch.profiler.record_function(name)``, so the profiler's trace
  holds it on the clock of the device's kernels, and every idle gap of the
  device can be put down to the span the host was in;
- appends a ``Record`` to an in-memory list on exit: its start and end
  (``time.perf_counter_ns``), the enclosing span of its thread, its
  thread, and its root, the outermost span of the thread (the "request",
  e.g. ``agent.call``), whose id every span under it shares.

A captured CUDA graph's body runs its Python once, at capture, and never
at replay, so no span goes inside one: spans mark the host calls around
the graphs (capture, replay), never the steps in them.

``records()``, ``counters()`` and ``totals()`` read what was recorded,
from any thread; ``clear()`` forgets it.
"""

from __future__ import annotations

import functools
import itertools
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch.autograd.profiler as _autograd_profiler


class Record(NamedTuple):
    name: str
    id: int
    parent: Optional[int]   # the enclosing span of the same thread
    root: int               # the outermost span of the thread (itself at the top)
    thread: int
    start_ns: int
    end_ns: int


class Total(NamedTuple):
    seconds: float
    count: int
    self_seconds: float     # seconds less what the span's children cover


_lock = threading.Lock()
_records: List[Record] = []
_counters: Dict[str, int] = {}
_ids = itertools.count(1)
_local = threading.local()


def tracing() -> bool:
    """Whether a ``torch.profiler`` session runs: the profiler's own flag
    (a private name of torch, read here alone, so that a torch release
    that moves it breaks this function only)."""
    return _autograd_profiler._is_profiler_enabled


class _Off:
    """The span of tracing off: records nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "id", "parent", "root", "start", "annotation")

    def __init__(self, name: str):
        self.name = name
        self.id = next(_ids)

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1].id if stack else None
        self.root = stack[0].id if stack else self.id
        stack.append(self)
        self.annotation = _autograd_profiler.record_function(self.name)
        self.annotation.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self.annotation.__exit__(*exc)
        _stack().pop()
        record = Record(self.name, self.id, self.parent, self.root, threading.get_ident(),
                        self.start, end)
        with _lock:
            _records.append(record)
        return False


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def span(name: str):
    """A context that marks ``name`` while tracing is on (see the module)."""
    return _Span(name) if tracing() else _OFF


def spanned(name: str):
    """A decorator: every call of the function runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while tracing is on."""
    if tracing():
        with _lock:
            _counters[name] = _counters.get(name, 0) + n


def records() -> List[Record]:
    """The spans recorded so far, in the order they ended."""
    with _lock:
        return list(_records)


def counters() -> Dict[str, int]:
    with _lock:
        return dict(_counters)


def totals() -> Dict[str, Total]:
    """Seconds, count and self seconds of the recorded spans, by name.
    Spans of one thread nest, so a span's children never overlap and its
    self time is its length less theirs."""
    recs = records()
    children: Dict[int, int] = {}
    for r in recs:
        if r.parent is not None:
            children[r.parent] = children.get(r.parent, 0) + r.end_ns - r.start_ns
    out: Dict[str, Total] = {}
    for r in recs:
        length = r.end_ns - r.start_ns
        t = out.get(r.name, Total(0.0, 0, 0.0))
        out[r.name] = Total(t.seconds + length / 1e9, t.count + 1,
                            t.self_seconds + (length - children.get(r.id, 0)) / 1e9)
    return out


def clear() -> None:
    """Forget every record and counter."""
    with _lock:
        _records.clear()
        _counters.clear()
