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

A span is host time. The device time of the model's full-resolution
layers (a map in or out of ``HIRES_MIN_SIDE`` = 128 or more on a side:
hd512's, none of the 64x64 and 32x32 families') comes from a
``StageTimer``: while tracing is on, the train windows that run eagerly
on CUDA (``train/step.py`` ``_window``, never inside a capture) install
one with ``timing(window_timer(...))``; every ``models/layers.py`` block
hands it its shapes, and at the window's end it adds the counters
``hires.fwd_us``, ``hires.bwd_us`` (integer microseconds) of the
window's fastest step and ``hires.steps`` (1). A window with no such
layer records nothing.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import threading
import time
from typing import Callable, Dict, List, NamedTuple, Optional

import torch
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


# ---------------------------------------------------------------------------
# device time of the full-resolution layers
# ---------------------------------------------------------------------------
HIRES_MIN_SIDE = 128


def _cuda_event():
    return torch.cuda.Event(enable_timing=True)


class _Mark(torch.autograd.Function):
    """Identity whose backward calls ``then()``: at a layer's output it
    starts a backward traversal, at its input and parameters it ends one."""

    @staticmethod
    def forward(ctx, x, then):
        ctx.then = then
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.then()
        return g, None


def _marked(then: Callable, tree):
    """``tree`` (a tensor or nested dicts of tensors) with a ``_Mark`` on
    every tensor that autograd will differentiate."""
    if isinstance(tree, dict):
        return {k: _marked(then, v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor) and tree.requires_grad and torch.is_grad_enabled():
        return _Mark.apply(tree, then)
    return tree


class StageTimer:
    """Device time of the layers with a map of ``min_side`` or more on a
    side, in the fastest step of one eager window, from event pairs on the
    stream the window runs on. The window calls ``next_step()`` after each
    step. A host stall inside a timed layer adds its length to the pair
    (the device waits between the events), and only adds: the fastest
    step is the one with the fewest stalls.

    Forward: one pair around each call of such a layer. Backward: identity
    autograd functions (``_Mark``) at the layer's output, and at its input
    and parameters. A backward pass reaches the output's mark once the
    output's gradient is whole, and starts a traversal there; each end
    mark it reaches records the traversal's end, the last one counting.
    Autograd runs a pass's nodes in the reverse order of their creation,
    so every node the layer made runs between its output's mark and its
    last end mark; and it runs each node's backward on the stream of its
    forward, so the events order with the kernels. A pass that needs no
    gradient of the layer's input (the first layer of D, where the pass
    wants D's parameters) ends at its parameters' marks. The marks are
    views: no kernel, and the outputs and gradients are the same bit for
    bit.

    ``event`` makes an event with ``record()``, ``synchronize()`` and
    ``elapsed_time(end)`` in ms (a CUDA timing event by default)."""

    def __init__(self, min_side: int = HIRES_MIN_SIDE, event: Callable = _cuda_event):
        self.min_side = min_side
        self._event = event
        self._steps: List[tuple] = [([], [])]   # per step: forward pairs, backward pairs

    def covers(self, shapes) -> bool:
        """Whether a layer with these shapes (C, H, W maps; others are not
        maps) is timed."""
        return any(len(s) == 3 and min(s[1:]) >= self.min_side for s in shapes)

    def _record(self):
        e = self._event()
        e.record()
        return e

    def next_step(self) -> None:
        self._steps.append(([], []))

    def run(self, shapes, fn: Callable, params, x):
        """``fn(params, x) -> (y, state)``, timed when ``covers(shapes)``."""
        if not self.covers(shapes):
            return fn(params, x)
        forward, backward = self._steps[-1]
        passes: List[list] = []

        def start_pass():
            passes.append([self._record(), None])
            backward.append(passes[-1])

        def end_pass():
            if passes:
                passes[-1][1] = self._record()

        start = self._record()
        y, state = fn(_marked(end_pass, params), _marked(end_pass, x))
        forward.append((start, self._record()))
        return _marked(start_pass, y), state

    def totals(self) -> List[Dict[str, float]]:
        """{'fwd_ms', 'bwd_ms'} of each step with a timed layer, of its
        calls and the backward traversals that ended; waits for their
        events."""
        def ms(pairs) -> float:
            out = 0.0
            for a, b in pairs:
                if b is not None:
                    b.synchronize()
                    out += a.elapsed_time(b)
            return out

        return [{"fwd_ms": ms(f), "bwd_ms": ms(b)} for f, b in self._steps if f]

    def report(self) -> None:
        """The counters of the window's fastest step, where a timed layer
        ran."""
        steps = self.totals()
        if not steps:
            return
        t = min(steps, key=lambda t: t["fwd_ms"] + t["bwd_ms"])
        count("hires.fwd_us", int(round(1e3 * t["fwd_ms"])))
        count("hires.bwd_us", int(round(1e3 * t["bwd_ms"])))
        count("hires.steps", 1)


def window_timer(device: torch.device) -> Optional[StageTimer]:
    """A timer for a window on ``device``: only while tracing is on, on
    CUDA, and where the stream is not capturing (no event goes into a
    graph). None otherwise."""
    if not tracing() or device.type != "cuda" or torch.cuda.is_current_stream_capturing():
        return None
    return StageTimer()


def stage_timer() -> Optional[StageTimer]:
    """The timer this thread's window installed, if any."""
    return getattr(_local, "timer", None)


@contextlib.contextmanager
def timing(timer: Optional[StageTimer]):
    """Install ``timer`` for the body (nothing when None); report its
    counters when the body returns."""
    if timer is None:
        yield None
        return
    outer = stage_timer()
    _local.timer = timer
    try:
        yield timer
    finally:
        _local.timer = outer
    timer.report()
