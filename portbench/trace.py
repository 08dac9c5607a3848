"""What a ``--trace 1`` run records, and the profiler traces it reads.

``Record`` holds the run's spans (host intervals the benchmark times around
its calls into the program, and the program's own spans copied out),
counters, the kernel calls caught at the program's op boundaries while a
device trace ran, and the reduced device traces. The per-layer metric
readers under ``portbench/metrics`` read only this object.

``device_slice`` runs a bounded stretch of the window under
``torch.profiler`` with CUDA activity alone, so the host runs as it does
untraced; ``labelled_slice`` adds CPU activity over a shorter stretch to
name what the host was doing in each idle gap of the card.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import time

import torch


@dataclasses.dataclass
class Kernel:
    name: str
    t0: float  # seconds on the profiler's clock
    t1: float


@dataclasses.dataclass
class DeviceSlice:
    kernels: list  # Kernel, in start order
    window_s: float  # host seconds the slice lasted
    busy_s: float  # seconds in which some device operation ran
    gaps: list  # (start, end) idle stretches between device operations
    labels: dict = dataclasses.field(default_factory=dict)  # host label -> idle seconds
    clock_offset: float = 0.0  # trace clock minus time.perf_counter

    def kernel_seconds(self, match: str) -> float:
        return sum(k.t1 - k.t0 for k in self.kernels if match in k.name)


@dataclasses.dataclass
class Record:
    spans: list = dataclasses.field(default_factory=list)  # (name, t0, t1, attrs)
    counters: dict = dataclasses.field(default_factory=dict)
    calls: list = dataclasses.field(default_factory=list)  # (op, work fn -> (bytes, flops))
    slices: dict = dataclasses.field(default_factory=dict)  # name -> DeviceSlice
    values: dict = dataclasses.field(default_factory=dict)  # series the traffic measured

    def span_seconds(self, name: str) -> list:
        return [t1 - t0 for n, t0, t1, _ in self.spans if n == name]


def _union(intervals) -> tuple[float, list]:
    """Total covered length of (t0, t1) intervals and the gaps between them."""
    busy, gaps = 0.0, []
    end = None
    for t0, t1 in sorted(intervals):
        if end is None or t0 > end:
            if end is not None:
                gaps.append((end, t0))
            busy += t1 - t0
            end = t1
        elif t1 > end:
            busy += t1 - end
            end = t1
    return busy, gaps


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _device_events(prof) -> list:
    dev = torch.autograd.DeviceType.CUDA
    out = [Kernel(e.name, e.time_range.start / 1e6, e.time_range.end / 1e6)
           for e in prof.events() if e.device_type == dev]
    return sorted(out, key=lambda k: k.t0)


def _reduce(prof, window_s: float) -> DeviceSlice:
    kernels = _device_events(prof)
    busy, gaps = _union((k.t0, k.t1) for k in kernels)
    return DeviceSlice(kernels, window_s, busy, gaps)


@contextlib.contextmanager
def device_slice(record: Record, name: str):
    """Profile the body with CUDA activity; store the reduced trace under
    ``name``."""
    from torch.profiler import ProfilerActivity, profile

    _sync()
    acts = [ProfilerActivity.CUDA] if torch.cuda.is_available() else [ProfilerActivity.CPU]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        if torch.cuda.is_available():
            torch.ones(1, device="cuda")  # the anchor: starts a few us after t0
        yield
        _sync()
        window_s = time.perf_counter() - t0
    sl = _reduce(prof, window_s)
    if sl.kernels:
        sl.clock_offset = sl.kernels[0].t0 - t0
    record.slices[name] = sl


def _innermost(starts, events, t: float):
    """Name of the latest-starting host event that covers time ``t``."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(i - 4000, -1), -1):
        e = events[j]
        if e[1] >= t:
            return e[2]
    return "host (no operator)"


@contextlib.contextmanager
def labelled_slice(record: Record, name: str):
    """Profile the body with CPU and CUDA activity: the idle gaps of the card,
    summed by the innermost host operator running when each began."""
    from torch.profiler import ProfilerActivity, profile

    _sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        yield
        _sync()
        window_s = time.perf_counter() - t0
    sl = _reduce(prof, window_s)
    cpu = torch.autograd.DeviceType.CPU
    host = sorted((e.time_range.start / 1e6, e.time_range.end / 1e6, e.name)
                  for e in prof.events() if e.device_type == cpu)
    starts = [h[0] for h in host]
    for g0, g1 in sl.gaps:
        label = _innermost(starts, host, g0 + 1e-7)
        sl.labels[label] = sl.labels.get(label, 0.0) + (g1 - g0)
    record.slices[name] = sl


def label_by_spans(sl: DeviceSlice, spans: list) -> None:
    """Name each idle gap of a ``device_slice`` by the benchmark's span
    (``time.perf_counter`` seconds) covering its middle."""
    for g0, g1 in sl.gaps:
        mid = (g0 + g1) / 2 - sl.clock_offset
        label = next((n for n, t0, t1, _ in spans if t0 <= mid <= t1), "between spans")
        sl.labels[label] = sl.labels.get(label, 0.0) + (g1 - g0)


@contextlib.contextmanager
def catch_calls(record: Record, module, name: str, work):
    """Record ``work(*args, **kwargs)`` (a function returning (bytes, flops,
    peak)) for every call of ``module.name`` inside the body; the counts are
    made after the body, from the arguments kept."""
    orig = getattr(module, name)
    kept = []

    def caught(*args, **kwargs):
        kept.append((args, kwargs))
        return orig(*args, **kwargs)

    setattr(module, name, caught)
    try:
        yield
    finally:
        setattr(module, name, orig)
    record.calls.extend((name, work(*a, **kw)) for a, kw in kept)


def breakdown(sl: DeviceSlice) -> dict:
    """The contract's ``breakdown``: the device operations that took most
    time and the longest idle gaps by what the host was doing."""
    by_op: dict = {}
    for k in sl.kernels:
        by_op[k.name] = by_op.get(k.name, 0.0) + (k.t1 - k.t0)
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(sl.labels.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:120], s] for n, s in top],
            "idle_gaps": [[n[:120], s] for n, s in gaps]}


def roofline_pct(record: Record, kernel: str):
    """The caught calls' least time on the card (the larger of bytes at the
    HBM rate and operations at the call's peak, summed over the calls) over
    the device time of the kernels named ``kernel`` in the device trace, in
    percent; None where the trace holds no such kernel or call."""
    from portbench.work import bound_s

    sl = record.slices.get("device")
    least = sum(bound_s(nb, fl, peak)[0] for _, (nb, fl, peak, k) in record.calls
                if k == kernel)
    spent = sl.kernel_seconds(kernel) if sl is not None else 0.0
    if not least or not spent:
        return None
    return 100.0 * least / spent


def idle_pct(record: Record):
    """Share of the device trace's window in which no device operation ran."""
    sl = record.slices.get("device")
    if sl is None or sl.window_s <= 0 or not sl.kernels:
        return None
    return 100.0 * (1.0 - sl.busy_s / sl.window_s)
