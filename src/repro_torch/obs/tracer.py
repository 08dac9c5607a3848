"""Per-query span trees for the serving stack.

A ``TraceContext`` rides on ``SearchRequest.trace`` through the whole
request path — admission, queue wait, batch assembly, executable lookup
(hit/miss/retrace), device dispatch, grow-segment merge, per-replica
scatter fan-out, fusion re-score — and each stage appends a ``Span``.
Stages usually record retrospectively (``add_span(name, t0, t1)``) with
timestamps they measured anyway: a batch phase is timed ONCE and attributed
to every query in the batch, instead of each query carrying live span
objects across the pump/submit thread boundary. ``span()`` is the live
context-manager form for single-owner phases.

Timestamps are ``time.perf_counter()`` seconds (monotonic, sub-µs), so a
span tree is internally ordered but not wall-clock anchored; the Chrome
trace export (``obs.export``) rebases onto the tracer epoch.

``Tracer`` is the factory plus a bounded ring of finished traces —
``export_chrome`` turns them into a perfetto-loadable trace-event JSON.
Everything is lock-protected: spans are appended from submitter, pump, and
scatter-pool threads concurrently.

The port's own copy of ``repro/obs/tracer.py`` (stdlib only), under the same
``allanpoe_*`` names (DESIGN.md §12).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Iterator, Optional


class Span:
    """One named interval with attributes and children. ``t1`` is None
    while open; ``annotate`` merges attributes at any point."""

    __slots__ = ("name", "t0", "t1", "attrs", "children")

    def __init__(self, name: str, t0: float, attrs: Optional[dict] = None):
        self.name = name
        self.t0 = t0
        self.t1: Optional[float] = None
        self.attrs: dict = dict(attrs) if attrs else {}
        self.children: list[Span] = []

    @property
    def duration(self) -> float:
        return (self.t1 if self.t1 is not None else self.t0) - self.t0

    def annotate(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def end(self, t: Optional[float] = None) -> "Span":
        if self.t1 is None:
            self.t1 = time.perf_counter() if t is None else t
        return self

    def walk(self) -> Iterator["Span"]:
        yield self
        for child in list(self.children):
            yield from child.walk()

    def __repr__(self) -> str:
        return (
            f"Span({self.name!r}, dur={self.duration * 1e3:.3f}ms, "
            f"attrs={self.attrs}, children={len(self.children)})"
        )


class TraceContext:
    """The span tree of one query (or one background operation). Carried on
    ``SearchRequest.trace``; every instrumented stage hangs spans off the
    root. Thread-safe: the serving path appends from several threads."""

    _next_id = [0]
    _id_lock = threading.Lock()

    def __init__(self, name: str, tracer: Optional["Tracer"] = None, **attrs):
        with self._id_lock:
            self._next_id[0] += 1
            self.trace_id = self._next_id[0]
        self.name = name
        self.root = Span(name, time.perf_counter(), attrs)
        self._tracer = tracer
        self._lock = threading.Lock()

    # -- recording ----------------------------------------------------------

    def add_span(
        self,
        name: str,
        t0: float,
        t1: float,
        parent: Optional[Span] = None,
        **attrs,
    ) -> Span:
        """Retrospective span from timestamps the caller already measured
        (the batch-phase pattern: time once, attribute to every query)."""
        span = Span(name, t0, attrs)
        span.t1 = max(t1, t0)  # clamp: a span is never negative-length
        with self._lock:
            (parent or self.root).children.append(span)
        return span

    def span(self, name: str, parent: Optional[Span] = None, **attrs):
        """Live span as a context manager (single-owner phases)."""
        return _LiveSpan(self, name, parent, attrs)

    def annotate(self, **attrs) -> "TraceContext":
        with self._lock:
            self.root.attrs.update(attrs)
        return self

    def end(self) -> "TraceContext":
        self.root.end()
        if self._tracer is not None:
            self._tracer._finish(self)
        return self

    def __enter__(self) -> "TraceContext":
        return self

    def __exit__(self, *exc) -> None:
        self.end()

    # -- inspection ---------------------------------------------------------

    def spans(self) -> list[Span]:
        """Every span of the tree, pre-order (root first)."""
        with self._lock:
            return list(self.root.walk())

    def find(self, name: str) -> list[Span]:
        return [s for s in self.spans() if s.name == name]

    def span_names(self) -> list[str]:
        return [s.name for s in self.spans()]


class _LiveSpan:
    def __init__(self, ctx: TraceContext, name, parent, attrs):
        self._ctx = ctx
        self._name = name
        self._parent = parent
        self._attrs = attrs
        self.span: Optional[Span] = None

    def __enter__(self) -> Span:
        self.span = Span(self._name, time.perf_counter(), self._attrs)
        with self._ctx._lock:
            (self._parent or self._ctx.root).children.append(self.span)
        return self.span

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            self.span.annotate(error=repr(exc))
        self.span.end()


class Tracer:
    """TraceContext factory + bounded ring of finished traces. ``keep``
    bounds memory: a service tracing every query forever retains only the
    most recent ``keep`` trees."""

    def __init__(self, keep: int = 256):
        self.epoch = time.perf_counter()  # chrome-export time zero
        self._lock = threading.Lock()
        self._finished: deque[TraceContext] = deque(maxlen=keep)

    def trace(self, name: str, **attrs) -> TraceContext:
        return TraceContext(name, tracer=self, **attrs)

    def _finish(self, ctx: TraceContext) -> None:
        with self._lock:
            self._finished.append(ctx)

    @property
    def finished(self) -> list[TraceContext]:
        with self._lock:
            return list(self._finished)

    def export_chrome(self, path=None) -> dict:
        """Chrome trace-event JSON over every finished trace; see
        ``obs.export.chrome_trace``."""
        from repro_torch.obs.export import chrome_trace, write_chrome_trace

        if path is not None:
            return write_chrome_trace(path, self)
        return chrome_trace(self.finished, epoch=self.epoch)
