"""Dependency-free metrics registry for the serving stack.

Three instrument kinds — ``Counter``, ``Gauge``, and fixed-bucket streaming
``Histogram`` — live in a ``MetricsRegistry`` and share ONE lock, so every
increment is atomic with respect to every other (the ``ServiceStats``
counters this replaces were bumped from multiple submitter threads with no
lock at all). Metrics follow the ``allanpoe_<layer>_<name>`` naming
convention (DESIGN.md §12) and may declare label dimensions (bucket size,
fusion mode, replica id, segment group, ...): each distinct label-value
combination is an independent child series, Prometheus-style.

Histograms are streaming: observations land in fixed log-spaced buckets, so
p50/p90/p99 come from bucket counts by linear interpolation — no sample
array is ever stored, and the same quantile code serves both the production
registry and the benches (the "bench = production metrics" invariant:
``serving_bench``/``fig14_scale`` read their percentiles from here).

Exposition is two-format: ``render()`` emits Prometheus text,
``snapshot()`` a JSON-able dict (``dump()`` writes it; the service pump
thread flushes it periodically — ``ServiceConfig.metrics_dump_path``).

``GLOBAL`` is the process-wide registry for signals that are inherently
process-global, such as the served index's ``allanpoe_index_bytes_total``
gauges (``serving.hybrid_service``).

The port's own copy of ``repro/obs/metrics.py`` (stdlib only), under the same
``allanpoe_*`` names (DESIGN.md §12).
"""

from __future__ import annotations

import json
import math
import pathlib
import threading
from typing import Optional, Sequence, Union


def time_buckets(
    lo: float = 1e-4, hi: float = 60.0, ratio: float = 1.25
) -> tuple[float, ...]:
    """Geometric latency-bucket upper bounds in seconds (~60 buckets from
    100µs to 60s at ratio 1.25 — fine enough that an interpolated p99 sits
    within 25% of the true value, the resolution the serving p99 gate
    assumes)."""
    out = [lo]
    while out[-1] < hi:
        out.append(out[-1] * ratio)
    return tuple(out)


DEFAULT_TIME_BUCKETS = time_buckets()


class HistogramSnapshot:
    """Immutable (bounds, counts, sum, count) capture of one histogram
    series; quantiles interpolate within the containing bucket. Snapshots
    subtract (``minus``), so benches can scope percentiles to exactly the
    requests of one measurement window on a shared registry."""

    __slots__ = ("bounds", "counts", "sum", "count")

    def __init__(
        self,
        bounds: tuple[float, ...],
        counts: tuple[int, ...],
        total: float,
        count: int,
    ):
        self.bounds = bounds
        self.counts = counts  # len(bounds) + 1: last is the overflow bucket
        self.sum = total
        self.count = count

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def minus(self, other: "HistogramSnapshot") -> "HistogramSnapshot":
        if other.bounds != self.bounds:
            raise ValueError("snapshot bucket bounds differ")
        return HistogramSnapshot(
            self.bounds,
            tuple(a - b for a, b in zip(self.counts, other.counts)),
            self.sum - other.sum,
            self.count - other.count,
        )

    def quantile(self, q: float) -> float:
        """q-th quantile (0..1) by linear interpolation inside the bucket
        holding the target rank. Empty series -> 0.0; overflow-bucket ranks
        clamp to the last finite bound."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        if self.count <= 0:
            return 0.0
        target = q * self.count
        seen = 0.0
        for i, c in enumerate(self.counts):
            if c <= 0:
                continue
            if seen + c >= target:
                if i >= len(self.bounds):  # overflow bucket
                    return self.bounds[-1]
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = self.bounds[i]
                frac = (target - seen) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
            seen += c
        return self.bounds[-1]


class _Metric:
    """Base of the three instrument kinds: a named family of label-keyed
    child series sharing the registry lock."""

    kind = "untyped"

    def __init__(
        self, registry: "MetricsRegistry", name: str, help: str,
        label_names: tuple[str, ...],
    ):
        self._registry = registry
        self._lock = registry._lock
        self.name = name
        self.help = help
        self.label_names = label_names
        self._children: dict[tuple, float] = {}

    def _key(self, labels: dict) -> tuple:
        if set(labels) != set(self.label_names):
            raise ValueError(
                f"{self.name} takes labels {self.label_names}, "
                f"got {tuple(labels)}"
            )
        return tuple(str(labels[n]) for n in self.label_names)

    def value(self, **labels) -> float:
        with self._lock:
            return self._children.get(self._key(labels), 0.0)

    def total(self) -> float:
        """Sum over every child series (the unlabeled view of a labeled
        counter — what the legacy ``ServiceStats`` fields report)."""
        with self._lock:
            return sum(self._children.values())

    def values(self) -> dict[tuple, float]:
        with self._lock:
            return dict(self._children)

    def reset(self) -> None:
        with self._lock:
            self._children.clear()

    def _series(self):
        """[(label-values tuple, value-ish)] for exposition, under lock."""
        return sorted(self._children.items())


class Counter(_Metric):
    kind = "counter"

    def inc(self, n: Union[int, float] = 1, **labels) -> None:
        if n < 0:
            raise ValueError("counters only go up")
        key = self._key(labels)
        with self._lock:
            self._children[key] = self._children.get(key, 0.0) + n


class Gauge(_Metric):
    kind = "gauge"

    def set(self, v: Union[int, float], **labels) -> None:
        with self._lock:
            self._children[self._key(labels)] = float(v)

    def inc(self, n: Union[int, float] = 1, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._children[key] = self._children.get(key, 0.0) + n

    def dec(self, n: Union[int, float] = 1, **labels) -> None:
        self.inc(-n, **labels)


class _HistSeries:
    __slots__ = ("counts", "sum", "count")

    def __init__(self, n_buckets: int):
        self.counts = [0] * n_buckets
        self.sum = 0.0
        self.count = 0


class Histogram(_Metric):
    kind = "histogram"

    def __init__(
        self, registry, name, help, label_names,
        buckets: Sequence[float] = DEFAULT_TIME_BUCKETS,
    ):
        super().__init__(registry, name, help, label_names)
        bounds = tuple(float(b) for b in buckets)
        if list(bounds) != sorted(set(bounds)):
            raise ValueError("histogram buckets must be strictly increasing")
        self.bounds = bounds
        self._children: dict[tuple, _HistSeries] = {}

    def _child(self, key: tuple) -> _HistSeries:
        child = self._children.get(key)
        if child is None:
            child = self._children[key] = _HistSeries(len(self.bounds) + 1)
        return child

    def observe(self, v: float, **labels) -> None:
        v = float(v)
        if math.isnan(v):
            return
        key = self._key(labels)
        # bisect by hand to stay inside the one lock acquisition
        lo, hi = 0, len(self.bounds)
        while lo < hi:
            mid = (lo + hi) // 2
            if v <= self.bounds[mid]:
                hi = mid
            else:
                lo = mid + 1
        with self._lock:
            child = self._child(key)
            child.counts[lo] += 1
            child.sum += v
            child.count += 1

    def snapshot(self, **labels) -> HistogramSnapshot:
        with self._lock:
            child = self._children.get(self._key(labels))
            if child is None:
                return HistogramSnapshot(
                    self.bounds, (0,) * (len(self.bounds) + 1), 0.0, 0
                )
            return HistogramSnapshot(
                self.bounds, tuple(child.counts), child.sum, child.count
            )

    def quantile(self, q: float, **labels) -> float:
        return self.snapshot(**labels).quantile(q)

    def value(self, **labels) -> float:  # the family's scalar view = count
        with self._lock:
            child = self._children.get(self._key(labels))
            return float(child.count) if child is not None else 0.0

    def total(self) -> float:
        with self._lock:
            return float(sum(c.count for c in self._children.values()))


def _fmt_labels(names: tuple[str, ...], values: tuple, extra: str = "") -> str:
    parts = [f'{n}="{v}"' for n, v in zip(names, values)]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _fmt_num(v: float) -> str:
    return str(int(v)) if float(v).is_integer() else repr(float(v))


class MetricsRegistry:
    """Named metrics behind one lock; idempotent registration (asking for an
    existing name returns the existing instrument, but kind/labels must
    match — a name can never silently change meaning)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}

    def _register(self, cls, name, help, labels, **kw) -> _Metric:
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if type(existing) is not cls or existing.label_names != tuple(labels):
                    raise ValueError(
                        f"metric {name} already registered as "
                        f"{existing.kind}{existing.label_names}"
                    )
                return existing
        metric = cls(self, name, help, tuple(labels), **kw)
        with self._lock:
            return self._metrics.setdefault(name, metric)

    def counter(self, name: str, help: str = "", labels: Sequence[str] = ()) -> Counter:
        return self._register(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "", labels: Sequence[str] = ()) -> Gauge:
        return self._register(Gauge, name, help, labels)

    def histogram(
        self, name: str, help: str = "", labels: Sequence[str] = (),
        buckets: Sequence[float] = DEFAULT_TIME_BUCKETS,
    ) -> Histogram:
        return self._register(Histogram, name, help, labels, buckets=buckets)

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def value(self, name: str, **labels) -> float:
        """Scalar read of a series (histograms report their count); an
        unregistered name reads 0 — absent and never-incremented are the
        same thing to a gate."""
        metric = self.get(name)
        if metric is None:
            return 0.0
        return metric.value(**labels) if labels else metric.total()

    def metrics(self) -> list[_Metric]:
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    # -- exposition ---------------------------------------------------------

    def snapshot(self) -> dict:
        """JSON-able dump of every series (the METRICS_snapshot.json
        artifact format)."""
        out: dict = {}
        for m in self.metrics():
            entry: dict = {"type": m.kind, "labels": list(m.label_names)}
            if m.help:
                entry["help"] = m.help
            series = []
            with self._lock:
                rows = m._series()
                if isinstance(m, Histogram):
                    for key, child in rows:
                        series.append({
                            "labels": dict(zip(m.label_names, key)),
                            "count": child.count,
                            "sum": child.sum,
                            "buckets": list(m.bounds),
                            "counts": list(child.counts),
                        })
                else:
                    for key, v in rows:
                        series.append({
                            "labels": dict(zip(m.label_names, key)),
                            "value": v,
                        })
            if isinstance(m, Histogram):
                for s in series:
                    snap = HistogramSnapshot(
                        m.bounds, tuple(s["counts"]), s["sum"], s["count"]
                    )
                    s["p50"] = snap.quantile(0.50)
                    s["p90"] = snap.quantile(0.90)
                    s["p99"] = snap.quantile(0.99)
            entry["series"] = series
            out[m.name] = entry
        return out

    def render(self) -> str:
        """Prometheus text exposition format."""
        lines: list[str] = []
        for m in self.metrics():
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            with self._lock:
                rows = m._series()
            if isinstance(m, Histogram):
                for key, child in rows:
                    cum = 0
                    for bound, c in zip(m.bounds, child.counts):
                        cum += c
                        lab = _fmt_labels(
                            m.label_names, key, f'le="{_fmt_num(bound)}"'
                        )
                        lines.append(f"{m.name}_bucket{lab} {cum}")
                    lab = _fmt_labels(m.label_names, key, 'le="+Inf"')
                    lines.append(f"{m.name}_bucket{lab} {child.count}")
                    lab = _fmt_labels(m.label_names, key)
                    lines.append(f"{m.name}_sum{lab} {_fmt_num(child.sum)}")
                    lines.append(f"{m.name}_count{lab} {child.count}")
            else:
                for key, v in rows:
                    lab = _fmt_labels(m.label_names, key)
                    lines.append(f"{m.name}{lab} {_fmt_num(v)}")
        return "\n".join(lines) + ("\n" if lines else "")

    def dump(self, path) -> None:
        """Atomic-enough JSON snapshot write (tmp + rename): a reader never
        sees a torn file even if the pump thread is mid-flush."""
        p = pathlib.Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        tmp = p.with_suffix(p.suffix + ".tmp")
        tmp.write_text(json.dumps(self.snapshot(), indent=2) + "\n")
        tmp.replace(p)


def merged_snapshot(*registries: MetricsRegistry) -> dict:
    """One snapshot dict across several registries (e.g. a service registry
    plus ``GLOBAL``); later registries win name collisions, which cannot
    happen under the <layer> naming convention."""
    out: dict = {}
    for reg in registries:
        out.update(reg.snapshot())
    return out


# process-wide registry: the served index's byte gauges live here
GLOBAL = MetricsRegistry()
