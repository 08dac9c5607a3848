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

Inside the core (search rounds, build stages) nothing carries a context
through the call: ``tracing(ctx)`` makes one *active* for the body (a
``contextvars.ContextVar``, so per thread), and ``span(name)`` /
``count(name, value)`` record into it, each span under the innermost span
still open. With no active context a span site costs one lookup and enters
a shared null context: no span, no device operation, no sync. A counted
value may be a device tensor (a mask, say); its elements are summed on the
device and read once, when the ``tracing`` body ends. ``tracing`` also
reads ``(time.time_ns(), time.perf_counter_ns())`` back to back at its
start and end, so ``TraceContext.unix_ns`` puts a span's ``perf_counter``
times on CLOCK_REALTIME, the clock of ``torch.profiler``'s events.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import operator
import threading
import time
from collections import deque
from typing import Iterator, Optional

# (context, innermost open span) of the running thread's active tracing
_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("repro_torch_obs_active",
                                                         default=None)


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
        self.counters: dict = {}
        self._pending: dict = {}  # counter name -> device values not yet read
        # (time.time_ns(), time.perf_counter_ns()) when tracing began / ended
        self.clock: Optional[tuple] = None
        self.clock_end: Optional[tuple] = None

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

    def count(self, name: str, value) -> None:
        """Add ``value`` to counter ``name``: a number at once; a tensor's
        element sum when ``settle`` runs (no device work and no read
        here)."""
        with self._lock:
            if isinstance(value, (int, float)):
                self.counters[name] = self.counters.get(name, 0) + value
            else:
                self._pending.setdefault(name, []).append(value)

    def settle(self) -> None:
        """Sum each counter's tensors on their device and read the sum: one
        read per counter."""
        with self._lock:
            pending, self._pending = self._pending, {}
        for name, values in pending.items():
            total = functools.reduce(operator.add, (v.sum() for v in values)).item()
            with self._lock:
                self.counters[name] = self.counters.get(name, 0) + total

    def graft(self, parent: Span, other: "TraceContext") -> None:
        """Hang ``other``'s top-level spans under ``parent`` and add its
        counters to this context's: a batch's core spans, timed once, in
        each member request's tree."""
        with self._lock:
            parent.children.extend(other.root.children)
            for name, v in other.counters.items():
                self.counters[name] = self.counters.get(name, 0) + v

    def unix_ns(self, t: float) -> int:
        """``t``, a span's ``time.perf_counter`` seconds, in CLOCK_REALTIME
        nanoseconds (``torch.profiler``'s clock): the offset between the two
        clocks from the pairs read when tracing began and ended, interpolated
        between them."""
        if self.clock is None:
            raise ValueError("this context was never active under tracing()")
        (u0, p0), (u1, p1) = self.clock, self.clock_end or self.clock
        pt = t * 1e9
        off = u0 - p0
        if p1 != p0:
            off += ((u1 - p1) - (u0 - p0)) * (pt - p0) / (p1 - p0)
        return round(pt + off)

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
    """A live span; ``scoped`` makes it the innermost open span of the
    active context while it is open (``span``)."""

    __slots__ = ("_ctx", "_name", "_parent", "_attrs", "_scoped", "_token", "span")

    def __init__(self, ctx: TraceContext, name, parent, attrs, scoped: bool = False):
        self._ctx = ctx
        self._name = name
        self._parent = parent
        self._attrs = attrs
        self._scoped = scoped
        self._token = None
        self.span: Optional[Span] = None

    def __enter__(self) -> Span:
        self.span = Span(self._name, time.perf_counter(), self._attrs)
        with self._ctx._lock:
            (self._parent or self._ctx.root).children.append(self.span)
        if self._scoped:
            self._token = _ACTIVE.set((self._ctx, self.span))
        return self.span

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._token is not None:
            _ACTIVE.reset(self._token)
        if exc_type is not None:
            self.span.annotate(error=repr(exc))
        self.span.end()


class _Null:
    """What a span site enters when no context is active."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> None:
        return None


_NULL = _Null()


def _clock_pair() -> tuple:
    """``(time.time_ns(), time.perf_counter_ns())`` read together: of three
    tries, the realtime read with the least perf_counter time around it, and
    the middle of that interval (a thread preempted between two reads would
    shift every span it maps)."""
    best = None
    for _ in range(3):
        p0 = time.perf_counter_ns()
        u = time.time_ns()
        p1 = time.perf_counter_ns()
        if best is None or p1 - p0 < best[0]:
            best = (p1 - p0, u, (p0 + p1) // 2)
    return best[1], best[2]


@contextlib.contextmanager
def tracing(ctx: Optional[TraceContext]):
    """Make ``ctx`` the active context of the body: ``span`` and ``count``
    record into it, the outermost spans under its root. On a clean exit its
    device counters are read (``settle``). ``tracing(None)`` activates
    nothing."""
    if ctx is None:
        yield None
        return
    if ctx.clock is None:
        ctx.clock = _clock_pair()
    token = _ACTIVE.set((ctx, ctx.root))
    done = False
    try:
        yield ctx
        done = True
    finally:
        _ACTIVE.reset(token)
        ctx.clock_end = _clock_pair()
        if done:
            ctx.settle()


def active() -> Optional[TraceContext]:
    """The active context, or None."""
    scope = _ACTIVE.get()
    return None if scope is None else scope[0]


def span(name: str, /, **attrs):
    """A live span under the innermost open span of the active context, as
    a context manager yielding the ``Span``; with no active context, the
    shared null context (yields None)."""
    scope = _ACTIVE.get()
    if scope is None:
        return _NULL
    return _LiveSpan(scope[0], name, scope[1], attrs, scoped=True)


def count(name: str, value) -> None:
    """Add ``value`` (a number, or a tensor whose elements are summed when
    the ``tracing`` body ends) to the active context's counter ``name``;
    nothing with no active context. A call site computes a tensor operand
    only when ``active()`` is not None."""
    scope = _ACTIVE.get()
    if scope is not None:
        scope[0].count(name, value)


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
