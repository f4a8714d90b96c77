"""The traced stretch of a run: the device's activities and the host's
events from ``torch.profiler``, reduced to what the per-layer metrics
read.

The activities are read from the profiler's raw results with the names
and filters ``prof.events()`` applies (the arithmetic of
``mmdgan_torch/tools/profile_step.py`` ``raw_activities``, copied: that
list costs about 50 us an event to build). Busy time is the union of the
device's intervals inside the stretch's window; idle is the rest of the
window.

Two kinds of window:

- ``graph_stretch``: whole replayed CUDA graphs (K-step windows), from the
  first kernel of one replay to the first kernel of the replay after the
  last: a steady period that holds every gap between windows, including
  the host's syncs between them. A kernel belongs to the replay whose
  ``cudaGraphLaunch`` carries its correlation id.
- ``host_stretch``: the interval of a host annotation around synchronous
  calls (a client's requests), so idle at both edges counts.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

Event = Tuple[str, int, int, int]   # name, start ns, end ns, correlation id


def profiler(device):
    """``torch.profiler.profile`` of the host, and of the card on CUDA."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    return profile(activities=acts)


def activities(prof) -> Tuple[List[Event], List[Event]]:
    """(device activities, host events), each with its correlation id
    (a kernel's is that of the runtime call that launched it), from the
    profiler's raw results."""
    # torch's own private helpers, imported here so that a torch release
    # that moves them breaks this reader alone
    from torch.autograd import DeviceType
    from torch.autograd.profiler_util import StringTable, _filter_name

    names = StringTable()
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        if _filter_name(e.name()) or getattr(e, "is_hidden_event", lambda: False)():
            continue
        if e.device_type() == DeviceType.CUDA:
            # a host annotation's range on the device's timeline is no work
            if getattr(e, "is_user_annotation", lambda: False)():
                continue
            device.append((names[e.name()], e.start_ns(), e.end_ns(), e.correlation_id()))
        elif e.device_type() == DeviceType.CPU:
            host.append((names[e.name()], e.start_ns(), e.end_ns(), e.correlation_id()))
    return device, host


def union_ns(intervals: Sequence[Tuple[int, int]]) -> int:
    """The length of the union of [start, end) intervals."""
    covered, reach = 0, None
    for lo, hi in sorted(intervals):
        if reach is None or lo > reach:
            covered += hi - lo
            reach = hi
        elif hi > reach:
            covered += hi - reach
            reach = hi
    return covered


class Stretch:
    """Device activities clipped to a window [w0, w1) (ns), the host's
    events over it, and the units of work in it: ``units`` of ``unit``
    ('step' of a train window, 'call' of a client)."""

    def __init__(self, device: Sequence[Event], host: Sequence[Event], w0: int, w1: int,
                 units: int, unit: str):
        if w1 <= w0:
            raise ValueError("an empty window")
        self.w0, self.w1, self.units, self.unit = w0, w1, units, unit
        self.kernels = [(n, max(s, w0), min(e, w1)) for n, s, e, _ in device
                        if e > w0 and s < w1]
        self.host = [(n, s, e) for n, s, e, _ in host if e > w0 and s < w1]

    @property
    def window_s(self) -> float:
        return (self.w1 - self.w0) / 1e9

    @property
    def busy_s(self) -> float:
        return union_ns([(s, e) for _, s, e in self.kernels]) / 1e9

    def by_name(self) -> Dict[str, Tuple[float, int]]:
        """Seconds and launches by activity name."""
        out: Dict[str, Tuple[float, int]] = {}
        for n, s, e in self.kernels:
            t, c = out.get(n, (0.0, 0))
            out[n] = (t + (e - s) / 1e9, c + 1)
        return out

    def gaps(self) -> List[Tuple[int, int]]:
        """The idle intervals of the window."""
        out, reach = [], self.w0
        for s, e in sorted((s, e) for _, s, e in self.kernels):
            if s > reach:
                out.append((reach, s))
            reach = max(reach, e)
        if reach < self.w1:
            out.append((reach, self.w1))
        return out

    def host_labels(self, times: Sequence[int]) -> List[str]:
        """The innermost host event (the latest to start) at each of the
        sorted ``times``."""
        import heapq

        events = sorted(self.host, key=lambda ev: ev[1])
        heap: list = []
        out, i = [], 0
        for t in times:
            while i < len(events) and events[i][1] <= t:
                n, s, e = events[i]
                heapq.heappush(heap, (-s, e, n))
                i += 1
            while heap and heap[0][1] <= t:
                heapq.heappop(heap)
            out.append(heap[0][2] if heap else "(no host event)")
        return out

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle time by
        what the host was doing at the middle of each gap."""
        ops = sorted(self.by_name().items(), key=lambda kv: -kv[1][0])[:top]
        gaps = self.gaps()
        idle: Dict[str, float] = {}
        for (s, e), label in zip(gaps, self.host_labels([(s + e) // 2 for s, e in gaps])):
            idle[label] = idle.get(label, 0.0) + (e - s) / 1e9
        worst = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, t] for n, (t, _) in ops],
                "idle_gaps": [[n, t] for n, t in worst]}


def graph_stretch(device: Sequence[Event], host: Sequence[Event], first: int, count: int,
                  steps_per_launch: int) -> Optional[Stretch]:
    """Replays ``first`` .. ``first + count - 1`` of the run's CUDA graph
    launches (in launch order): from the first kernel of replay ``first``
    to the first kernel of replay ``first + count``. None when the trace
    holds fewer replays or links no kernel to them."""
    launches = sorted((s, c) for n, s, _, c in host if n.startswith("cudaGraphLaunch"))
    if len(launches) < first + count + 1:
        return None
    starts: Dict[int, int] = {}
    for _, s, _, corr in device:
        if corr not in starts or s < starts[corr]:
            starts[corr] = s
    marks = [starts.get(c) for _, c in launches[first:first + count + 1]]
    if any(m is None for m in marks):
        return None
    return Stretch(device, host, marks[0], marks[-1], count * steps_per_launch, "step")


def host_stretch(device: Sequence[Event], host: Sequence[Event], annotation: str,
                 units: int) -> Optional[Stretch]:
    """The window of the host annotation ``annotation``."""
    spans = [(s, e) for n, s, e, _ in host if n == annotation]
    if not spans:
        return None
    s, e = spans[0]
    return Stretch(device, host, s, e, units, "call")
