"""Data-parallel replica tier: N ``HybridSearchService`` replicas behind a
thin router. Port of ``repro/serving/replica_router.py`` in one process.

Each replica owns a ``SegmentPool`` placement (its shard of the corpus,
with its own grow segment, write lock and seen-key cache): replicas share
no mutable state. The router in front is deliberately thin:

  * **placement** — documents map to replicas by consistent hashing of the
    global doc id over a ring with virtual nodes (``virtual_nodes`` per
    replica, BLAKE2b through ``hashlib``, so adding or removing a replica
    only remaps ~1/N of the id space, and the owners equal ``repro``'s for
    any names and ids). ``insert()`` allocates global ids, splits the batch
    by home replica, and forwards each slice to that replica's
    ``SegmentRouter`` with the ids pinned (``SegmentRouter.insert(
    global_ids=...)``), so an id's home is recomputable from the id alone;
    ``delete()`` routes the same way.
  * **reads** — ``search()`` scatter-gathers: every *up* replica searches
    the query batch over its shard on a thread pool, dispatched in
    least-outstanding-requests order, and the per-replica top-k blocks
    merge per row in global-id space via ``core.fusion.merge_fused_host``
    (shards are disjoint, so the merge is duplicate-free). The router
    resolves ONE ``FusionSpec`` — normalization stats pooled tier-wide by
    ``PathStats.merge`` so normalized scores compare across shards — and
    RRF rows merge by rank contributions recomputed over the union from
    per-path scores (DESIGN.md §11). A lone survivor is an identity merge.
  * **mirror mode** (``placement="mirror"``) — every replica holds the full
    corpus; a query batch goes to exactly one replica, the least loaded,
    and writes broadcast to all replicas.
  * **failure** — ``mark_down(i)`` removes a replica from the ring: writes
    rehash to the survivors, scatter reads skip its shard and are recorded
    as degraded (DESIGN.md §9) in the result (``down_replicas``), the
    counter and the trace, before any ``fail_on_partial`` raise.
    ``mark_up`` restores it.

Every replica's device work runs on one card here: the members' searches
return host results, and every snapshot publish synchronises the device
under the member's write lock, so no thread relies on another's queued work.

Equivalence contract: with saturating search parameters, scatter-gather
over any replica partition returns the same results as one service holding
every document, up to equal-score tie order.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core.fusion import (
    N_SCORE_PATHS,
    FusionSpec,
    PathStats,
    as_fusion_spec,
    merge_fused_host,
    stack_specs,
)
from repro_torch.core.search import SearchResult
from repro_torch.core.segment_pool import SegmentPool
from repro_torch.core.usms import FusedVectors, PathWeights
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.tracer import TraceContext, Tracer
from repro_torch.serving.hybrid_service import HybridSearchService
from repro_torch.serving.segment_router import SegmentRouter


def _hash64(data: bytes) -> int:
    # stable across processes and runs (unlike hash()): placement must be
    # recomputable from the id alone
    return int.from_bytes(hashlib.blake2b(data, digest_size=8).digest(), "big")


def build_ring(names: Sequence[str], virtual_nodes: int = 64) -> list[tuple[int, int]]:
    """Sorted (hash, owner-index) consistent-hash ring with virtual nodes.
    Offline shard builders use it with ``ring_homes`` to pre-partition a
    corpus exactly as the live tier routes it."""
    ring = [
        (_hash64(f"{name}#{v}".encode()), i)
        for i, name in enumerate(names)
        for v in range(virtual_nodes)
    ]
    return sorted(ring)


def ring_homes(ring: Sequence[tuple[int, int]], global_ids) -> np.ndarray:
    """Vectorized ring-successor lookup: owner index per doc id."""
    if not ring:
        raise RuntimeError("no replica is up")
    keys = np.asarray([k for k, _ in ring], np.uint64)
    owners = np.asarray([o for _, o in ring], np.int64)
    ids = np.atleast_1d(np.asarray(global_ids, np.int64))
    h = np.asarray([_hash64(int(g).to_bytes(8, "big", signed=False)) for g in ids], np.uint64)
    pos = np.searchsorted(keys, h, side="right") % len(keys)
    return owners[pos]


@dataclasses.dataclass(frozen=True)
class ReplicaTierConfig:
    # virtual ring nodes per replica: more nodes -> smoother shard balance
    virtual_nodes: int = 64
    # "hash": consistent-hash sharding, scatter-gather reads.
    # "mirror": full copy per replica, least-outstanding single dispatch.
    placement: str = "hash"
    # raise instead of returning shard-degraded results when replicas are down
    fail_on_partial: bool = False

    def __post_init__(self):
        if self.placement not in ("hash", "mirror"):
            raise ValueError("placement must be 'hash' or 'mirror'")
        if self.virtual_nodes < 1:
            raise ValueError("virtual_nodes must be >= 1")


class ReplicaTierStats:
    """Registry-backed view of the tier's counters (``allanpoe_replica_*``
    series in the router's metrics registry). Per-replica series are labeled
    with the replica NAME, stable across mark_down/mark_up; ``dispatched``
    re-exposes them as a positional list."""

    def __init__(self, metrics: MetricsRegistry, names: Sequence[str]):
        self._names = list(names)
        self._inserts = metrics.counter("allanpoe_replica_inserts_total", "tier insert() batches")
        self._inserted_docs = metrics.counter(
            "allanpoe_replica_inserted_docs_total", "documents routed to home replicas")
        self._deletes = metrics.counter("allanpoe_replica_deletes_total", "tier delete() calls")
        self._searches = metrics.counter("allanpoe_replica_searches_total", "tier search() calls")
        self._partial = metrics.counter(
            "allanpoe_replica_partial_searches_total",
            "scatter reads served with >=1 replica down")
        self._dispatched = metrics.counter(
            "allanpoe_replica_dispatched_total", "search dispatches per replica",
            labels=("replica",))
        self._degraded = metrics.counter(
            "allanpoe_replica_degraded_reads_total",
            "reads that were missing this replica's shard (it was down)",
            labels=("replica",))

    @property
    def inserts(self) -> int:
        return int(self._inserts.total())

    @property
    def inserted_docs(self) -> int:
        return int(self._inserted_docs.total())

    @property
    def deletes(self) -> int:
        return int(self._deletes.total())

    @property
    def searches(self) -> int:
        return int(self._searches.total())

    @property
    def partial_searches(self) -> int:
        return int(self._partial.total())

    @property
    def dispatched(self) -> list[int]:
        return [int(self._dispatched.value(replica=n)) for n in self._names]

    def degraded_reads(self, name: str) -> int:
        """Reads served without this replica's shard while it was down."""
        return int(self._degraded.value(replica=name))

    def __repr__(self) -> str:
        return (
            f"ReplicaTierStats(inserts={self.inserts}, "
            f"inserted_docs={self.inserted_docs}, deletes={self.deletes}, "
            f"searches={self.searches}, partial_searches={self.partial_searches}, "
            f"dispatched={self.dispatched})"
        )


class Replica:
    """One member of the tier: a service (its own snapshot and key cache)
    plus, for writable tiers, the grow-segment router that owns its shard's
    streaming writes."""

    def __init__(self, service: HybridSearchService, router: Optional[SegmentRouter] = None, *,
                 name: Optional[str] = None):
        self.service = service
        self.router = router
        self.name = name or f"replica{id(service):x}"
        self.up = True
        self.outstanding = 0  # in-flight search dispatches (LOR signal)


class ReplicaRouter:
    """Thin scatter/route layer over share-nothing service replicas."""

    def __init__(
        self,
        replicas: Sequence[Union[Replica, HybridSearchService]],
        config: Optional[ReplicaTierConfig] = None,
        *,
        metrics: Optional[MetricsRegistry] = None,
        tracer: Optional[Tracer] = None,
    ):
        if not replicas:
            raise ValueError("a replica tier needs at least one replica")
        self.config = config or ReplicaTierConfig()
        self.replicas = [
            r if isinstance(r, Replica) else Replica(r, name=f"replica{i}")
            for i, r in enumerate(replicas)
        ]
        names = [r.name for r in self.replicas]
        if len(set(names)) != len(names):
            raise ValueError(f"replica names must be unique, got {names}")
        self.metrics = metrics or MetricsRegistry()
        self.tracer = tracer or Tracer()
        self.stats = ReplicaTierStats(self.metrics, names)
        self._lock = threading.Lock()  # ring + outstanding counters
        self._ring: list[tuple[int, int]] = []
        self._rebuild_ring()
        self._next_gid = 1 + max((self._max_gid(r) for r in self.replicas), default=-1)
        self._pool = ThreadPoolExecutor(max_workers=len(self.replicas),
                                        thread_name_prefix="replica-scatter")

    # -- lifecycle ----------------------------------------------------------

    def close(self) -> None:
        """Join the scatter pool and every replica's pump and merge workers."""
        self._pool.shutdown(wait=True)
        for r in self.replicas:
            r.service.stop_pump()  # joins the attached router's merge worker too

    def __enter__(self) -> "ReplicaRouter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- consistent-hash placement ------------------------------------------

    _hash = staticmethod(_hash64)

    def _rebuild_ring(self) -> None:
        ring = []
        for i, r in enumerate(self.replicas):
            if not r.up:
                continue
            for v in range(self.config.virtual_nodes):
                ring.append((_hash64(f"{r.name}#{v}".encode()), i))
        with self._lock:
            self._ring = sorted(ring)

    def homes_of(self, global_ids) -> np.ndarray:
        """Home replica index per doc id (ring successor of each hash)."""
        with self._lock:
            ring = list(self._ring)
        return ring_homes(ring, global_ids)

    def replica_for(self, global_id: int) -> int:
        """Home replica index of a single doc id."""
        return int(self.homes_of([global_id])[0])

    def mark_down(self, i: int) -> None:
        """Take replica i out of rotation: writes rehash to survivors,
        scatter reads skip its shard (degraded results, counted)."""
        with self._lock:
            self.replicas[i].up = False
        self._rebuild_ring()

    def mark_up(self, i: int) -> None:
        with self._lock:
            self.replicas[i].up = True
        self._rebuild_ring()

    def _up(self) -> list[int]:
        return [i for i, r in enumerate(self.replicas) if r.up]

    @staticmethod
    def _max_gid(r: Replica) -> int:
        if r.router is not None:
            return r.router._next_gid - 1
        idx = r.service.index
        if isinstance(idx, SegmentPool):
            return idx.max_global_id()
        return int(idx.n) - 1

    # -- writes -------------------------------------------------------------

    def insert(self, new_docs: FusedVectors, *, generator: Optional[torch.Generator] = None,
               new_doc_entities: Optional[np.ndarray] = None) -> np.ndarray:
        """Allocate global ids, split the batch by home replica, forward
        each slice to that replica's grow segment. Returns the allocated
        ids (the caller's handle for later deletes). Mirror tiers broadcast
        the whole batch to every up replica instead. ``generator`` is passed
        to every replica's insert; left out, each router seeds its own."""
        n = int(new_docs.n)
        if n == 0:
            return np.zeros((0,), np.int64)
        gids = np.arange(self._next_gid, self._next_gid + n, dtype=np.int64)
        self._next_gid += n
        if self.config.placement == "mirror":
            targets = {i: np.arange(n) for i in self._up()}
        else:
            homes = self.homes_of(gids)
            targets = {int(i): np.flatnonzero(homes == i) for i in np.unique(homes)}
        for i, rows in targets.items():
            r = self.replicas[i]
            if r.router is None:
                raise ValueError(f"replica {r.name} has no SegmentRouter: the tier cannot "
                                 "route writes to it")
            sub = new_docs.take(torch.as_tensor(rows, dtype=torch.long, device=new_docs.device))
            ents = None if new_doc_entities is None else np.asarray(new_doc_entities)[rows]
            r.router.insert(sub, generator=generator, new_doc_entities=ents,
                            global_ids=gids[rows])
        self.stats._inserts.inc()
        self.stats._inserted_docs.inc(n)
        return gids

    def delete(self, global_ids) -> int:
        """Tombstone docs on their home replicas (every replica, for a
        mirror tier). Returns the number of ids routed."""
        ids = np.atleast_1d(np.asarray(global_ids, np.int64))
        if self.config.placement == "mirror":
            for i in self._up():
                self.replicas[i].router.delete(ids)
        else:
            homes = self.homes_of(ids)
            for i in np.unique(homes):
                self.replicas[int(i)].router.delete(ids[homes == i])
        self.stats._deletes.inc()
        return int(ids.size)

    # -- reads --------------------------------------------------------------

    def _dispatch_order(self, up: list[int]) -> list[int]:
        """Least-outstanding-requests first: the loaded replica's work is
        queued last (scatter) or avoided entirely (mirror)."""
        with self._lock:
            return sorted(up, key=lambda i: (self.replicas[i].outstanding, i))

    def _member_search(self, i: int, queries, fusion, kw, en, k, trace=None) -> SearchResult:
        r = self.replicas[i]
        with self._lock:
            r.outstanding += 1
        self.stats._dispatched.inc(replica=r.name)
        t0 = time.perf_counter()
        try:
            return r.service.search(queries, fusion, keywords=kw, entities=en, k=k, trace=trace)
        finally:
            with self._lock:
                r.outstanding -= 1
            if trace is not None:
                trace.add_span("replica_dispatch", t0, time.perf_counter(), replica=r.name)

    def path_stats(self) -> PathStats:
        """ONE tier-wide normalization-stats object: the up replicas'
        running stats pooled by live shard size (``PathStats.merge``), so
        normalized fusion scores compare across shards (DESIGN.md §11)."""
        up = self._up()
        sizes = self.shard_sizes()
        return PathStats.merge([self.replicas[i].service.path_stats for i in up],
                               [sizes[i] for i in up])

    def _resolve_spec(self, fusion) -> FusionSpec:
        """Coerce the query-side fusion argument to ONE resolved spec for
        the whole tier: sequences stack to a batched spec, and unresolved
        (stats=None) specs pin to the tier-wide pooled stats so every member
        normalizes identically."""
        if isinstance(fusion, (FusionSpec, PathWeights)):
            spec = as_fusion_spec(fusion)
        else:
            spec = stack_specs([as_fusion_spec(f) for f in fusion])
        if spec.stats is not None:
            return spec
        stats = self.path_stats()
        if np.ndim(spec.mode) >= 1:  # a batched spec needs (B, 3) stat leaves
            b = int(np.shape(spec.mode)[0])
            bs = lambda x: torch.as_tensor(x, dtype=torch.float32).expand(
                b, N_SCORE_PATHS).contiguous()
            stats = PathStats(minv=bs(stats.minv), maxv=bs(stats.maxv), mean=bs(stats.mean),
                              std=bs(stats.std))
        return dataclasses.replace(spec, stats=stats)

    def search(
        self,
        queries: FusedVectors,
        fusion: Union[FusionSpec, PathWeights, Sequence, None] = None,
        *,
        weights: Union[PathWeights, Sequence[PathWeights], None] = None,
        keywords: Optional[np.ndarray] = None,
        entities: Optional[np.ndarray] = None,
        k: Optional[int] = None,
        trace: Optional[TraceContext] = None,
    ) -> SearchResult:
        """Batched read. Hash tiers scatter to every up replica and merge
        per-row top-k in global-id space; mirror tiers dispatch the batch to
        the single least-loaded replica. ``weights=`` is the deprecated
        ``PathWeights`` spelling. Results are host tensors.

        Degraded scatter reads (>= 1 replica down) are recorded three ways:
        in the result (``SearchResult.down_replicas``), as the labeled
        counter ``allanpoe_replica_degraded_reads_total{replica}``, and as a
        ``down_replicas`` annotation on ``trace`` — all before the optional
        ``fail_on_partial`` raise, so the audit trail survives the error."""
        if fusion is not None and weights is not None:
            raise ValueError("pass fusion= or (deprecated) weights=, not both")
        if fusion is None:
            if weights is None:
                raise TypeError("search() requires fusion=FusionSpec(...)")
            fusion = weights  # deprecated form; as_fusion_spec warns
        spec = self._resolve_spec(fusion)
        up = self._dispatch_order(self._up())
        if not up:
            raise RuntimeError("no replica is up")
        self.stats._searches.inc()
        if self.config.placement == "mirror":
            return self._member_search(up[0], queries, spec, keywords, entities, k, trace)
        down = tuple(r.name for r in self.replicas if not r.up)
        if down:
            self.stats._partial.inc()
            for name in down:
                self.stats._degraded.inc(replica=name)
            if trace is not None:
                trace.annotate(down_replicas=list(down))
            if self.config.fail_on_partial:
                raise RuntimeError(f"replicas down ({list(down)}) and fail_on_partial is set")
        # a lone survivor still flows through the parts path below, so
        # degraded reads carry the same spans as full scatters
        t_sc = time.perf_counter()
        futures = [self._pool.submit(self._member_search, i, queries, spec, keywords, entities,
                                     k, trace) for i in up]
        parts = [f.result() for f in futures]
        t_gather = time.perf_counter()
        if trace is not None:
            trace.add_span("scatter_gather", t_sc, t_gather, replicas=len(up), down=list(down))
        host = lambda t: t.detach().cpu().numpy()
        if len(parts) == 1:
            # identity merge: re-ranking a single shard's rows could reorder
            # ties, breaking the one-replica == one-service equivalence
            m_ids, m_scores, m_ps = (host(parts[0].ids), host(parts[0].scores),
                                     host(parts[0].path_scores))
        else:
            m_ids, m_scores, m_ps = merge_fused_host(
                [host(p.ids) for p in parts], [host(p.scores) for p in parts],
                [host(p.path_scores) for p in parts], spec, int(parts[0].ids.shape[1]))
        if trace is not None:
            trace.add_span("fusion_rescore", t_gather, time.perf_counter(), parts=len(parts),
                           site="replica_merge")
        expanded = np.sum([host(p.expanded).astype(np.int64) for p in parts], axis=0)
        return SearchResult(
            ids=torch.as_tensor(m_ids),
            scores=torch.as_tensor(m_scores),
            expanded=torch.as_tensor(expanded, dtype=torch.int32),
            path_scores=torch.as_tensor(m_ps),
            down_replicas=down or None,
        )

    # -- introspection ------------------------------------------------------

    @property
    def n_replicas(self) -> int:
        return len(self.replicas)

    def shard_sizes(self) -> list[int]:
        """Live docs per replica (balance diagnostic)."""
        out = []
        for r in self.replicas:
            idx = r.service.index
            if isinstance(idx, SegmentPool):
                alive = sum(int(g.index.alive.sum().item()) for g in idx.groups)
            else:
                alive = int(idx.alive.sum().item())
            grow = r.service.grow_index
            if grow is not None:
                alive += int(grow.alive.sum().item())
            out.append(alive)
        return out
