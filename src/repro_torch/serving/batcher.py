"""Micro-batching for the hybrid-search serving path.

The paper's throughput story (§5, 1.5x-186.4x) assumes the GPU sees *batches*
of queries, not one-at-a-time calls. This module turns a stream of
heterogeneous requests (any ``PathWeights``, optional keywords/entities, any
``k``) into fixed-shape batches:

  * the batch dimension is padded up to a power of two (``Bucket.batch``) so
    a handful of executables covers every arrival pattern;
  * keyword / entity widths are padded to power-of-two bucket caps, so a
    request with 3 keywords and one with none land in the same executable;
  * a bounded FIFO queue decouples arrival from execution, flushing when
    ``flush_size`` requests are pending (throughput mode) or when the oldest
    request has waited ``flush_deadline_s`` (latency bound).

The batcher is deliberately passive: it never runs a search itself. The
service (``hybrid_service.HybridSearchService``) drains ready batches and
owns the executable-cache keys. Deadlines are evaluated on ``submit`` and on
``poll``, which the service's pump thread drives.

Port of ``repro/serving/batcher.py``, whole; a request's ``query`` holds
unbatched torch tensors.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Optional

import numpy as np

from repro_torch.core.fusion import FusionSpec, as_fusion_spec
from repro_torch.core.usms import FusedVectors, PathWeights
from repro_torch.obs.tracer import TraceContext


class QueueFullError(RuntimeError):
    """Raised when the bounded request queue rejects a submit (backpressure:
    the execution path is not draining fast enough; callers shed load or
    retry with backoff)."""


class AdmissionError(RuntimeError):
    """Raised when token-bucket admission control rejects a submit BEFORE it
    reaches the queue (rate policy, not backpressure — deliberately a
    distinct type from ``QueueFullError`` so callers and stats can tell
    "you are over quota" from "the service is saturated")."""


# ---------------------------------------------------------------------------
# Token-bucket admission control (per-tenant quotas + a global ceiling).
# Sits in FRONT of MicroBatcher.enqueue: the bounded queue remains the
# backpressure backstop, the buckets enforce rate policy.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class QuotaConfig:
    """One token bucket: sustained ``rate`` requests/s with ``burst`` depth."""

    rate: float
    burst: float

    def __post_init__(self):
        if self.rate < 0 or self.burst <= 0:
            raise ValueError("quota needs rate >= 0 and burst > 0")


@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    """``global_quota`` caps the whole service; ``tenant_quotas`` pins named
    tenants; ``default_tenant_quota`` applies to any other named tenant.
    Requests with ``tenant=None`` only face the global bucket."""

    global_quota: Optional[QuotaConfig] = None
    default_tenant_quota: Optional[QuotaConfig] = None
    tenant_quotas: tuple[tuple[str, QuotaConfig], ...] = ()
    # cap on lazily-created tenant buckets: beyond it the oldest bucket is
    # evicted (it re-fills to a full burst if that tenant returns — a mild
    # over-admit, vs. unbounded growth under high-cardinality tenant ids)
    max_tenant_buckets: int = 4096


class TokenBucket:
    """Classic token bucket; time is injectable for deterministic tests."""

    __slots__ = ("rate", "burst", "_tokens", "_t")

    def __init__(self, quota: QuotaConfig, now: Optional[float] = None):
        self.rate = float(quota.rate)
        self.burst = float(quota.burst)
        self._tokens = self.burst  # start full: allow an initial burst
        self._t = time.monotonic() if now is None else now

    @property
    def tokens(self) -> float:
        return self._tokens

    def try_acquire(self, n: float = 1.0, now: Optional[float] = None) -> bool:
        now = time.monotonic() if now is None else now
        if now > self._t:
            self._tokens = min(self.burst, self._tokens + (now - self._t) * self.rate)
            self._t = now
        if self._tokens >= n:
            self._tokens -= n
            return True
        return False

    def refund(self, n: float = 1.0) -> None:
        self._tokens = min(self.burst, self._tokens + n)


class AdmissionController:
    """Tenant bucket first, then the global bucket (with refund on a global
    reject, so a saturated service never silently drains tenant quota).

    Not internally locked: the service calls ``try_admit`` under its queue
    lock, which also serializes lazy tenant-bucket creation."""

    def __init__(self, cfg: AdmissionConfig, now: Optional[float] = None):
        self.cfg = cfg
        self._quota_by_tenant = dict(cfg.tenant_quotas)
        self._global = (
            TokenBucket(cfg.global_quota, now) if cfg.global_quota else None
        )
        self._tenants: dict[str, TokenBucket] = {}

    def _tenant_bucket(self, tenant: Optional[str], now: float) -> Optional[TokenBucket]:
        if tenant is None:
            return None
        bucket = self._tenants.get(tenant)
        if bucket is None:
            quota = self._quota_by_tenant.get(tenant, self.cfg.default_tenant_quota)
            if quota is None:
                return None
            while len(self._tenants) >= self.cfg.max_tenant_buckets:
                self._tenants.pop(next(iter(self._tenants)))  # oldest first
            bucket = self._tenants[tenant] = TokenBucket(quota, now)
        return bucket

    def try_admit(self, tenant: Optional[str] = None, now: Optional[float] = None) -> bool:
        now = time.monotonic() if now is None else now
        tb = self._tenant_bucket(tenant, now)
        if tb is not None and not tb.try_acquire(1.0, now):
            return False
        if self._global is not None and not self._global.try_acquire(1.0, now):
            if tb is not None:
                tb.refund(1.0)
            return False
        return True

    def refund(self, tenant: Optional[str] = None) -> None:
        """Return an admitted request's tokens (all buckets it consumed
        from). Called when a request passes admission but is then rejected
        downstream (queue full): backpressure must not drain rate quota."""
        tb = self._tenants.get(tenant) if tenant is not None else None
        if tb is not None:
            tb.refund(1.0)
        if self._global is not None:
            self._global.refund(1.0)


@dataclasses.dataclass(frozen=True)
class BatcherConfig:
    max_queue: int = 1024  # bounded FIFO capacity (admission control)
    flush_size: int = 32  # flush as soon as this many requests are pending
    flush_deadline_s: float = 0.01  # ... or the oldest request is this stale
    max_batch: int = 64  # largest bucket batch (power of two)
    kw_cap: int = 8  # largest keyword width bucket
    ent_cap: int = 4  # largest entity width bucket

    def __post_init__(self):
        if self.flush_size > self.max_batch:
            raise ValueError("flush_size must be <= max_batch")


@dataclasses.dataclass(frozen=True)
class Bucket:
    """A fixed executable shape: (padded batch, keyword width, entity width).

    Hashable — it is the shape part of the executable-cache key."""

    batch: int
    kw_width: int
    ent_width: int


@dataclasses.dataclass
class SearchRequest:
    """One user query. ``query`` leaves are unbatched (dense (Dd,), sparse
    (P,)); ``fusion`` is a scalar-leaf ``FusionSpec`` (mode, weights, rrf_k,
    stats — stats=None defers to the service's running index stats);
    keywords/entities are 1-D id arrays (or None). ``weights`` is the
    deprecated ``PathWeights`` form: it converts to a weighted-sum spec on
    construction with a ``DeprecationWarning``."""

    query: FusedVectors
    fusion: Optional[FusionSpec] = None
    k: int = 10
    keywords: Optional[np.ndarray] = None
    entities: Optional[np.ndarray] = None
    tenant: Optional[str] = None  # admission-control quota key (None = global only)
    weights: Optional[PathWeights] = None  # deprecated: use fusion
    # optional span-tree context: every serving stage this request passes
    # through (admission, queue wait, batch phases) appends spans here — see
    # repro_torch.obs.tracer and DESIGN.md §12
    trace: Optional[TraceContext] = None

    def __post_init__(self):
        if self.fusion is not None and self.weights is not None:
            raise ValueError("pass fusion= or (deprecated) weights=, not both")
        if self.fusion is None:
            if self.weights is not None:
                self.fusion = as_fusion_spec(self.weights)  # warns
            # else: left unset; the service rejects it at submit time
        elif not isinstance(self.fusion, FusionSpec):
            self.fusion = as_fusion_spec(self.fusion)  # warns on PathWeights


class PendingResult:
    """Future-like handle filled when the request's batch executes."""

    __slots__ = (
        "_ids",
        "_scores",
        "_path_scores",
        "_expanded",
        "_error",
        "_event",
        "_service",
    )

    def __init__(self, service=None):
        self._ids = None
        self._scores = None
        self._path_scores = None
        self._expanded = 0
        self._error: Optional[BaseException] = None
        self._event = threading.Event()
        self._service = service

    @property
    def done(self) -> bool:
        return self._event.is_set()

    @property
    def expanded(self) -> int:
        """Nodes the beam search expanded for this query (work measure)."""
        return self._expanded

    @property
    def path_scores(self) -> Optional[np.ndarray]:
        """(k, 3) raw per-path scores of the returned ids (dense / learned /
        lexical), or None before fulfillment. Required by cross-replica RRF
        merges, which re-rank from raw path scores rather than fused ones."""
        return self._path_scores

    def _fulfill(
        self,
        ids: np.ndarray,
        scores: np.ndarray,
        expanded: int,
        path_scores: Optional[np.ndarray] = None,
    ) -> None:
        self._ids, self._scores, self._expanded = ids, scores, expanded
        self._path_scores = path_scores
        self._event.set()

    def _fail(self, error: BaseException) -> None:
        self._error = error
        self._event.set()

    def result(self, timeout: float = 600.0) -> tuple[np.ndarray, np.ndarray]:
        """(ids, scores) for this request, length == request.k. Forces a
        flush of the owning service if the request is still queued, then
        waits for delivery — the batch may be mid-execution on another
        thread (the timer-thread deployment mode)."""
        if not self.done and self._service is not None:
            try:
                self._service.flush()
            except Exception:
                # flush re-raises the drain's first batch error, which may
                # belong to a DIFFERENT request's batch; our own outcome —
                # result or error — arrives through _fulfill/_fail below
                pass
        if not self._event.wait(timeout):
            raise TimeoutError(f"search request not completed in {timeout}s")
        if self._error is not None:
            raise self._error
        return self._ids, self._scores


@dataclasses.dataclass
class _Entry:
    request: SearchRequest
    pending: PendingResult
    arrival_s: float  # time.monotonic(): deadline clock (injectable in tests)
    # time.perf_counter() at enqueue: queue-wait attribution start. A
    # separate stamp because the tests inject `now` into the monotonic
    # deadline clock, and spans/histograms must stay on the real clock.
    arrival_perf: float = 0.0


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def bucket_for(entries: list[_Entry], cfg: BatcherConfig) -> Bucket:
    """Smallest power-of-two bucket covering a batch of requests."""
    b = min(_next_pow2(len(entries)), cfg.max_batch)
    kw = max(
        (len(e.request.keywords) for e in entries if e.request.keywords is not None),
        default=0,
    )
    en = max(
        (len(e.request.entities) for e in entries if e.request.entities is not None),
        default=0,
    )
    return Bucket(
        batch=b,
        kw_width=min(max(_next_pow2(kw), 1), cfg.kw_cap),
        ent_width=min(max(_next_pow2(en), 1), cfg.ent_cap),
    )


class MicroBatcher:
    """Bounded FIFO of pending requests with size/deadline flush triggers."""

    def __init__(self, cfg: BatcherConfig):
        self.cfg = cfg
        self._queue: deque[_Entry] = deque()

    def __len__(self) -> int:
        return len(self._queue)

    def enqueue(
        self, request: SearchRequest, pending: PendingResult, now: Optional[float] = None
    ) -> None:
        if len(self._queue) >= self.cfg.max_queue:
            raise QueueFullError(
                f"request queue full ({self.cfg.max_queue}); shed load or retry"
            )
        now = time.monotonic() if now is None else now
        self._queue.append(_Entry(request, pending, now, time.perf_counter()))

    def due(self, now: Optional[float] = None) -> bool:
        """True when a flush trigger has fired (size or deadline)."""
        if len(self._queue) >= self.cfg.flush_size:
            return True
        if not self._queue:
            return False
        now = time.monotonic() if now is None else now
        return now - self._queue[0].arrival_s >= self.cfg.flush_deadline_s

    def take_ready(
        self, now: Optional[float] = None, force: bool = False
    ) -> list[tuple[Bucket, list[_Entry]]]:
        """Pop batches whose trigger fired (all pending ones if ``force``),
        in FIFO order, each at most ``max_batch`` requests with its bucket."""
        out: list[tuple[Bucket, list[_Entry]]] = []
        while self._queue and (force or self.due(now)):
            entries = [
                self._queue.popleft()
                for _ in range(min(len(self._queue), self.cfg.max_batch))
            ]
            out.append((bucket_for(entries, self.cfg), entries))
        return out
