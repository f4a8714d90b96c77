"""What the readers of the program's own spans share.

The program (``mmdgan_torch/utils/spans.py``) marks its layer boundaries
while a profiler runs: each span is a host event of the traced stretch,
on the clock of the device's activities, and its totals are kept in the
program. Idle inside spans is the device's idle gaps in the stretch
(``Stretch.gaps``) intersected with the union of the named spans, so it
never exceeds the stretch's idle time. A program that records no such
span (one older than its spans) reads nothing here, and raises nothing.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple


def merged(intervals: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """The union of [start, end) intervals, as sorted disjoint intervals."""
    out: List[Tuple[int, int]] = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return out


def overlap_ns(a: Sequence[Tuple[int, int]], b: Sequence[Tuple[int, int]]) -> int:
    """The length of the intersection of two sorted lists of disjoint
    intervals."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_ms_per_unit(run, names: Sequence[str], unit: str) -> Optional[float]:
    """Idle milliseconds inside the host spans named ``names`` per unit of
    a stretch of ``unit`` ('step' or 'call'); None without such a stretch,
    or when it holds none of the spans."""
    st = run.stretch
    if st is None or st.unit != unit:
        return None
    spans = merged([(s, e) for n, s, e in st.host if n in names])
    if not spans:
        return None
    return 1e3 * overlap_ns(st.gaps(), spans) / 1e9 / st.units


def program_totals() -> Optional[Dict]:
    """The program's span totals by name (``spans.totals()``: seconds,
    count, self seconds), or None where the program has no spans."""
    try:
        from mmdgan_torch.utils import spans
    except ImportError:
        return None
    return spans.totals()
