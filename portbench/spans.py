"""Device time inside spans: the helpers the span readers and
``core_trace.py`` share.

A reader's spans are ``Record.spans`` (``time.perf_counter`` seconds); the
device trace's operations are on the profiler's clock, ``clock_offset``
ahead. The helpers take any one clock and unit.
"""

from __future__ import annotations

import bisect


def merged(intervals) -> list:
    """The union of (t0, t1) intervals as sorted, disjoint intervals."""
    out: list = []
    for t0, t1 in sorted(intervals):
        if out and t0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t1)
        else:
            out.append([t0, t1])
    return out


def covered(busy: list, a, b):
    """Length of [a, b) that ``busy`` (from ``merged``) covers."""
    i = bisect.bisect_right(busy, a, key=lambda iv: iv[1])
    total = 0
    while i < len(busy) and busy[i][0] < b:
        total += max(0, min(b, busy[i][1]) - max(a, busy[i][0]))
        i += 1
    return total


def innermost(spans: list, t, outside: str = "outside the program") -> str:
    """Name of the latest-starting span of ``spans`` ((t0, t1, name), sorted)
    open at ``t``: with nested spans, the innermost."""
    for j in range(bisect.bisect_right(spans, t, key=lambda s: s[0]) - 1, -1, -1):
        if spans[j][1] > t:
            return spans[j][2]
    return outside


def idle_pct_in(record, name: str):
    """Share of the time inside the spans named ``name`` that the device
    trace covers (spans that overlap its first to last operation) in which
    no device operation ran, in percent; None without a device trace or
    such a span."""
    sl = record.slices.get("device")
    if sl is None or not sl.kernels:
        return None
    lo, hi = sl.kernels[0].t0, max(k.t1 for k in sl.kernels)
    spans = [(t0 + sl.clock_offset, t1 + sl.clock_offset)
             for n, t0, t1, _ in record.spans if n == name]
    spans = [(a, b) for a, b in spans if a < hi and b > lo and b > a]
    total = sum(b - a for a, b in spans)
    if total <= 0:
        return None
    busy = merged((k.t0, k.t1) for k in sl.kernels)
    return 100.0 * (1.0 - sum(covered(busy, a, b) for a, b in spans) / total)
