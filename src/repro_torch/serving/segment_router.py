"""Grow-segment streaming router for a pool-fronted service. Port of
``repro/serving/segment_router.py`` on one device.

The paper's index takes inserts without a rebuild (§4.1 "Updates"). A
served ``SegmentPool`` absorbs writes with the grow-segment scheme of vector
databases (Milvus growing segments):

  * **growing**: ``insert()`` batches land in one small ``HybridIndex``, the
    *grow segment*, born through ``build_index`` and extended by
    ``core.build_pipeline.insert``. Sealed segments are never touched, so
    their cache keys stay valid; the read path merges sealed + grow per row
    in global-id space (``HybridSearchService._merge_grow``). The published
    grow segment is padded to a power-of-two capacity
    (``RouterConfig.grow_pow2``), so reads see O(log growth) grow shapes
    between compactions;
  * **sealed**: the pool's immutable shape groups. Deletes resolve global
    ids to (group, segment, local row) tombstones, shape-preserving;
  * **compacted**: when the grow segment's live docs reach
    ``RouterConfig.seal_threshold``, ``compact()`` runs the configured
    compaction. ``compact_incremental`` (the default) seals the live grow
    rows into ONE new pooled segment (O(grow) build work, tombstoned grow
    rows dropped, entity rows carried) at pow2 capacity; untouched groups
    keep their keys, and a size-tiered ``maybe_merge_segments`` policy
    bounds fragmentation LSM-style, by default on a background worker.
    ``seal_and_compact`` rebuilds every surviving doc into one fresh
    segment (O(corpus), every tombstone reclaimed), keeping global ids.

Every mutation runs under the service's write lock and lands as one atomic
snapshot publish: readers see (old sealed, old grow) or (new sealed, new
grow), never a mix.

Randomness: where ``repro`` takes a ``key`` (derived as
``fold_in(key(17 | 23 | 29 | 31), version)`` for inserts, full rebuilds,
incremental seals and merges), each write here takes a ``generator`` and
optional ``draws``. Left out, the generator is seeded from the same
(salt, version) pair (``SegmentRouter._randomness``). The mesh (placement of groups over devices) waits for the multi-GPU
slice (ROADMAP Queue 1 item 5): on one device placement is the identity.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core.build_pipeline import (
    BuildDraws,
    build_index,
    map_index_rows,
    pad_index_rows,
    slice_index_rows,
)
from repro_torch.core.build_pipeline import insert as index_insert
from repro_torch.core.distributed import SegmentedIndex, compact_segmented_index
from repro_torch.core.index import BuildConfig, HybridIndex
from repro_torch.core.index import mark_deleted as index_mark_deleted
from repro_torch.core.logical_edges import build_logical_edges
from repro_torch.core.search import SearchParams
from repro_torch.core.segment_pool import (
    SegmentPool,
    alive_docs_pool,
    append_segment,
    build_pool_segment,
    extract_segment_docs,
    live_counts,
    mark_deleted_pool,
    remove_segments,
    resolve_global_ids_pool,
    widen_entities,
)
from repro_torch.core.usms import PAD_IDX, FusedVectors, cat_fused, quantize_corpus
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.serving.batcher import _next_pow2
from repro_torch.serving.hybrid_service import HybridSearchService

# repro's key salts: key(salt) folded with the snapshot version
INSERT_SALT, FULL_SALT, SEAL_SALT, MERGE_SALT = 17, 23, 29, 31


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    seal_threshold: int = 256  # live grow docs that trigger compaction
    auto_compact: bool = True  # compact from insert() when over threshold
    # optional override for the insert probe's search breadth (k and the
    # edge paths are forced by the build config; see build_pipeline.insert)
    insert_search: Optional[SearchParams] = None
    # opt-in acknowledgement that compacting a KG-bearing index WITHOUT the
    # triplets permanently drops the entity paths
    allow_kg_loss_on_compact: bool = False
    # pad the PUBLISHED grow segment to the next power of two (pad rows are
    # dead and unreachable), so reads see O(log growth) grow shapes
    grow_pow2: bool = True
    # "incremental" seals the grow segment into ONE pooled segment (O(grow)
    # build work); "full" rebuilds every surviving doc (O(corpus)). None =
    # auto: incremental (the port serves pools only)
    compaction: Optional[str] = None
    # quantize sealed pool-segment capacity to the next power of two, so
    # segments land in O(log corpus) shape groups
    seal_pow2: bool = True
    # size-tiered merge invariant: at most tier_fanout segments per
    # pow2-capacity tier; auto_merge enforces it after each incremental
    # compaction
    tier_fanout: int = 4
    auto_merge: bool = True
    # run auto merges on a background worker thread (each merge still takes
    # the service write lock); wait_merges() blocks until it is quiescent
    background_merge: bool = True
    # every N compactions persist the sealed pool (and the paired ingest
    # manifest) via checkpoint.index_io.save_pool. 0 = off.
    autocheckpoint_every: int = 0
    autocheckpoint_dir: Optional[str] = None


# retained names: the row pad/slice helpers live in core.build_pipeline so
# the segment pool shares them
_map_grow_rows = map_index_rows
pad_grow_to_capacity = pad_index_rows
slice_grow_rows = slice_index_rows


class RouterStats:
    """Registry-backed view of the router's write-path counters: every field
    is an ``allanpoe_router_*`` series in the owning service's registry."""

    def __init__(self, metrics: MetricsRegistry):
        self._inserts = metrics.counter(
            "allanpoe_router_inserts_total", "insert() calls absorbed by the grow segment")
        self._inserted_docs = metrics.counter(
            "allanpoe_router_inserted_docs_total", "documents appended to the grow segment")
        self._deletes = metrics.counter("allanpoe_router_deletes_total", "delete() calls")
        self._deleted_docs = metrics.counter(
            "allanpoe_router_deleted_docs_total",
            "ids tombstoned, by where they lived "
            "(unknown = found nowhere, already compacted away?)",
            labels=("target",),
        )
        self._compactions = metrics.counter(
            "allanpoe_router_compactions_total",
            "grow-segment seals, full rebuilds vs incremental pool appends",
            labels=("mode",),
        )
        self._merges = metrics.counter("allanpoe_router_merges_total",
                                       "background segment merges")
        self._autocheckpoints = metrics.counter(
            "allanpoe_router_autocheckpoints_total", "pool checkpoints written by the router")

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
    def deleted_sealed(self) -> int:
        return int(self._deleted_docs.value(target="sealed"))

    @property
    def deleted_grow(self) -> int:
        return int(self._deleted_docs.value(target="grow"))

    @property
    def unknown_deletes(self) -> int:
        return int(self._deleted_docs.value(target="unknown"))

    @property
    def compactions(self) -> int:
        return int(self._compactions.total())

    @property
    def incremental_compactions(self) -> int:
        return int(self._compactions.value(mode="incremental"))

    @property
    def merges(self) -> int:
        return int(self._merges.total())

    @property
    def autocheckpoints(self) -> int:
        return int(self._autocheckpoints.total())

    def __repr__(self) -> str:
        return (
            f"RouterStats(inserts={self.inserts}, inserted_docs={self.inserted_docs}, "
            f"deletes={self.deletes}, deleted_sealed={self.deleted_sealed}, "
            f"deleted_grow={self.deleted_grow}, unknown_deletes={self.unknown_deletes}, "
            f"compactions={self.compactions}, "
            f"incremental_compactions={self.incremental_compactions}, "
            f"merges={self.merges}, autocheckpoints={self.autocheckpoints})"
        )


def _rows(corpus: FusedVectors, rows: np.ndarray) -> FusedVectors:
    sel = torch.as_tensor(rows, dtype=torch.long, device=corpus.device)
    return corpus.take(sel)


class SegmentRouter:
    """Fronts a pool-serving ``HybridSearchService`` with a grow segment.

    Constructing a router attaches it to the service: ``service.insert`` /
    ``service.mark_deleted`` delegate here, and the service's read path
    merges the grow segment once one exists."""

    def __init__(
        self,
        service: HybridSearchService,
        build_cfg: BuildConfig,
        config: Optional[RouterConfig] = None,
        *,
        kg_triplets: Optional[np.ndarray] = None,
        n_entities: int = 0,
        ingest=None,
    ):
        if not service._pool:
            raise ValueError(
                "SegmentRouter fronts a SegmentPool service; a single HybridIndex "
                "already supports insert()/mark_deleted() directly")
        self.service = service
        # a fitted ingest.IngestPipeline: auto-checkpoints pair it with the pool
        self._ingest = ingest
        self.build_cfg = build_cfg
        self.config = config or RouterConfig()
        self.stats = RouterStats(service.metrics)
        self._ckpt_lock = threading.Lock()  # serializes checkpoint writes
        self._last_ckpt_compactions = 0
        self._merge_lock = threading.Lock()  # merge-worker start/stop
        self._merge_thread: Optional[threading.Thread] = None
        self._merge_wake = threading.Event()
        self._merge_idle = threading.Event()
        self._merge_idle.set()
        self._merge_stop = threading.Event()
        self._kg_triplets = None if kg_triplets is None else np.asarray(kg_triplets, np.int32)
        self._n_entities = int(n_entities)
        snap = service._snap
        pool: SegmentPool = snap.index
        self._device = pool.groups[0].global_ids.device
        self._next_gid = pool.max_global_id() + 1
        # entity_adj is (1, 1) for a KG-less build: anything wider means the
        # pool carries entity paths a triplet-less compaction would destroy
        if pool.has_kg and self._kg_triplets is None and not self.config.allow_kg_loss_on_compact:
            raise ValueError(
                "the sealed index carries knowledge-graph data but the router has no "
                "kg_triplets: compaction would drop every entity path. Pass "
                "kg_triplets/n_entities, or set "
                "RouterConfig(allow_kg_loss_on_compact=True) to accept it.")
        self._grow_raw: Optional[HybridIndex] = None
        if snap.grow_gids is not None:
            # re-attaching over a live grow segment: its ids were allocated
            # past the sealed ones and must never be handed out again
            n_grow = int(snap.grow_gids.shape[0])
            self._next_gid = max(self._next_gid, int(snap.grow_gids.max()) + 1)
            # the raw (unpadded) grow segment inserts extend
            self._grow_raw = slice_grow_rows(snap.grow, n_grow)
        service._router = self

    # -- introspection ------------------------------------------------------

    @property
    def grow_size(self) -> int:
        """Real rows in the grow segment (tombstoned ones included, pow2
        padding excluded)."""
        gids = self.service._snap.grow_gids
        return 0 if gids is None else int(gids.shape[0])

    @property
    def grow_capacity(self) -> int:
        """Published grow-segment capacity (grow_size rounded up to a power
        of two under ``RouterConfig.grow_pow2``)."""
        grow = self.service._snap.grow
        return 0 if grow is None else int(grow.n)

    @property
    def live_grow_size(self) -> int:
        """Non-tombstoned grow docs: the seal-threshold measure."""
        grow = self.service._snap.grow
        return 0 if grow is None else int(grow.alive.sum().item())

    @property
    def pool(self) -> SegmentPool:
        """The sealed segment pool."""
        return self.service._snap.index

    @property
    def compaction_mode(self) -> str:
        return self.config.compaction or "incremental"

    def _corpus_dtype(self) -> str:
        """Sealed storage dtype: the service's resolved SearchParams, so the
        cache key and the storage always agree."""
        return self.service.params.corpus_dtype

    def _kg_kwargs(self, doc_entities: Optional[np.ndarray]) -> dict:
        if self._kg_triplets is None or self._n_entities <= 0:
            return {}
        return dict(kg_triplets=self._kg_triplets, doc_entities=doc_entities,
                    n_entities=self._n_entities)

    def _randomness(self, salt: int, n: int, generator, draws):
        """(generator, draws) of a write that builds ``n`` rows: the
        caller's, the generator else seeded from (salt, snapshot version)."""
        if generator is None:
            version = self.service._snap.version
            generator = torch.Generator(device=self._device).manual_seed((salt << 32) + version)
        return generator, draws

    # -- writes (all under the service write lock, atomic publishes) --------

    def insert(
        self,
        new_docs: FusedVectors,
        *,
        generator: Optional[torch.Generator] = None,
        draws: Optional[BuildDraws] = None,
        new_doc_entities: Optional[np.ndarray] = None,
        global_ids: Optional[np.ndarray] = None,
    ) -> int:
        """Absorb a batch of new docs into the grow segment; returns the new
        snapshot version. Never touches sealed segments. May compact when
        the grow segment reaches the threshold and ``auto_compact`` is on.

        ``global_ids`` pins the docs' ids instead of allocating them here:
        they must be fresh (>= this router's next id) and strictly
        increasing, keeping the grow map sorted for the delete path."""
        svc = self.service
        n_new = int(new_docs.n)
        if n_new == 0:
            return svc.snapshot_version
        if global_ids is not None:
            global_ids = np.asarray(global_ids, np.int64)
            if global_ids.shape != (n_new,):
                raise ValueError(f"global_ids must be ({n_new},) to map every new doc")
            if global_ids.size and (int(global_ids[0]) < self._next_gid
                                    or (np.diff(global_ids) <= 0).any()):
                raise ValueError(
                    "pinned global_ids must be strictly increasing and >= the router's "
                    f"next id ({self._next_gid}): grow gids stay sorted so deletes "
                    "resolve by searchsorted")
        last = int(global_ids[-1]) if global_ids is not None else self._next_gid + n_new - 1
        if last >= 2**31:
            raise ValueError("global ids are int32: the id space is spent")
        if new_doc_entities is not None:
            if self._kg_triplets is None:
                raise ValueError(
                    "new_doc_entities given but the router has no knowledge graph: "
                    "pass kg_triplets/n_entities at construction")
            new_doc_entities = np.asarray(new_doc_entities, np.int32)
            ent_width = svc._snap.index.entity_width
            if new_doc_entities.shape != (n_new, ent_width):
                raise ValueError(
                    f"new_doc_entities must be ({n_new}, {ent_width}) to match the sealed "
                    "index's entity width")
        new_docs = new_docs.to(self._device)
        with svc._write_lock:
            snap = svc._snap
            generator, draws = self._randomness(INSERT_SALT, n_new, generator, draws)
            new_gids = (np.arange(self._next_gid, self._next_gid + n_new, dtype=np.int32)
                        if global_ids is None else global_ids.astype(np.int32))
            if snap.grow is None:
                kg_kwargs = {}
                if self._kg_triplets is not None:
                    # a KG router always births the grow segment with the
                    # sealed entity width (all-PAD rows when the batch has
                    # none), so later entity inserts pass insert's check
                    ents = new_doc_entities
                    if ents is None:
                        ents = np.full((n_new, snap.index.entity_width), PAD_IDX, np.int32)
                    kg_kwargs = dict(kg_triplets=self._kg_triplets, doc_entities=ents,
                                     n_entities=self._n_entities)
                grow = build_index(new_docs, self.build_cfg, generator=generator, draws=draws,
                                   device=self._device, **kg_kwargs)
                gids = torch.as_tensor(new_gids, device=self._device)
            else:
                # inserts extend the RAW grow segment: the published one may
                # carry a pow2 dead tail that must not become real neighbors
                grow = index_insert(self._grow_raw, new_docs, self.build_cfg,
                                    generator=generator, draws=draws,
                                    new_doc_entities=new_doc_entities,
                                    search_params=self.config.insert_search)
                if new_doc_entities is not None:
                    # entity paths of docs inserted into a born grow segment
                    # append now, not at the next compaction
                    grow = self._rebuild_grow_logical_edges(grow)
                gids = torch.cat([snap.grow_gids,
                                  torch.as_tensor(new_gids, device=self._device)])
            self._next_gid = int(new_gids[-1]) + 1
            self._grow_raw = grow
            if self.config.grow_pow2:
                grow = pad_grow_to_capacity(grow, _next_pow2(grow.n))
            svc._publish(snap.index, grow=grow, grow_gids=gids)
            self.stats._inserts.inc()
            self.stats._inserted_docs.inc(n_new)
            version = svc._snap.version
        if self.config.auto_compact and self.live_grow_size >= self.config.seal_threshold:
            return self.compact()
        return version

    def _rebuild_grow_logical_edges(self, grow: HybridIndex) -> HybridIndex:
        """Recompute the grow segment's logical edges over its FULL entity
        table (``build_pipeline.insert`` only appends PAD logical rows)."""
        if self._kg_triplets is None or self._n_entities <= 0:
            return grow
        log = build_logical_edges(
            self._kg_triplets, grow.doc_entities.cpu().numpy(), self._n_entities,
            l_cap=self.build_cfg.logical_cap, m_cap=self.build_cfg.entity_doc_cap)
        t = lambda a: torch.as_tensor(a, device=self._device)
        return dataclasses.replace(
            grow, logical_edges=t(log.edges), doc_entities=t(log.doc_entities),
            entity_to_docs=t(log.entity_to_docs), entity_adj=t(log.entity_adj))

    def compact(self, *, generator=None, draws=None) -> int:
        """Run the configured compaction: ``compact_incremental`` (O(grow)
        build work) or ``seal_and_compact`` (O(corpus))."""
        if self.compaction_mode == "incremental":
            return self.compact_incremental(generator=generator, draws=draws)
        return self.seal_and_compact(generator=generator, draws=draws)

    def delete(self, global_ids) -> int:
        """Tombstone docs by global id wherever they live: sealed ids as
        (group, segment, row) tombstones, grow ids in the grow segment. Both
        keep shapes. Returns the new snapshot version."""
        svc = self.service
        ids = np.atleast_1d(np.asarray(global_ids, np.int64))
        with svc._write_lock:
            snap = svc._snap
            grp, seg, loc = resolve_global_ids_pool(snap.index, ids)
            in_sealed = grp >= 0
            grow, grow_gids = snap.grow, snap.grow_gids
            in_grow = np.zeros(ids.shape, bool)
            if grow is not None:
                gmap = grow_gids.cpu().numpy()
                in_grow = np.isin(ids, gmap) & ~in_sealed
                if in_grow.any():
                    # grow gids are allocated in increasing order, so the map
                    # is sorted; rows are the same in the raw and padded view
                    rows = np.searchsorted(gmap, ids[in_grow])
                    grow = index_mark_deleted(grow, rows)
                    self._grow_raw = index_mark_deleted(self._grow_raw, rows)
            sealed = snap.index
            if in_sealed.any():
                sealed = mark_deleted_pool(
                    sealed, ids[in_sealed],
                    resolved=(grp[in_sealed], seg[in_sealed], loc[in_sealed]))
            svc._publish(sealed, grow=grow, grow_gids=grow_gids)
            self.stats._deletes.inc()
            self.stats._deleted_docs.inc(int(in_sealed.sum()), target="sealed")
            self.stats._deleted_docs.inc(int(in_grow.sum()), target="grow")
            self.stats._deleted_docs.inc(int((~in_sealed & ~in_grow).sum()), target="unknown")
            return svc._snap.version

    def seal_and_compact(self, *, generator=None, draws=None) -> int:
        """Rebuild every surviving doc (sealed minus tombstones, plus live
        grow docs) into ONE fresh segment keeping the global ids, and
        publish it as a one-group pool with the grow segment cleared: every
        tombstone reclaimed, every group's key replaced."""
        svc = self.service
        with svc._write_lock:
            snap = svc._snap
            pool: SegmentPool = snap.index
            tombstoned = any(bool((~g.index.alive & (g.global_ids >= 0)).any())
                             for g in pool.groups)
            if snap.grow is None and not tombstoned and pool.n_groups <= 1:
                return snap.version  # nothing growing, nothing to reclaim
            sealed_corpus, sealed_gids, sealed_ents = alive_docs_pool(pool)
            parts_corpus, parts_gids, parts_ents = [sealed_corpus], [sealed_gids], [sealed_ents]
            if snap.grow is not None:
                live = np.flatnonzero(snap.grow.alive.cpu().numpy())
                if live.size:
                    parts_corpus.append(_rows(snap.grow.corpus, live))
                    parts_gids.append(snap.grow_gids.cpu().numpy()[live])
                    # grow entity rows padded/clipped to the sealed width
                    parts_ents.append(widen_entities(
                        snap.grow.doc_entities.cpu().numpy()[live], sealed_ents.shape[-1]))
            corpus = cat_fused(parts_corpus)
            gids = np.concatenate(parts_gids)
            generator, draws = self._randomness(FULL_SALT, corpus.n, generator, draws)
            kg_kwargs = {}
            if self._kg_triplets is not None:
                kg_kwargs = dict(kg_triplets=self._kg_triplets,
                                 doc_entities=np.concatenate(parts_ents, axis=0),
                                 n_entities=self._n_entities)
            new_seg = compact_segmented_index(
                corpus, gids, 1, self.build_cfg, generator=generator,
                draws=None if draws is None else [draws], device=self._device, **kg_kwargs)
            if self._corpus_dtype() == "int8":
                # builds are always fp32; sealed storage quantizes here
                new_seg = SegmentedIndex(
                    dataclasses.replace(new_seg.index, corpus=quantize_corpus(new_seg.index.corpus)),
                    new_seg.global_ids)
            svc._publish(SegmentPool.from_segmented(new_seg), grow=None, grow_gids=None)
            self._grow_raw = None
            self.stats._compactions.inc(mode="full")
            version = svc._snap.version
        self._maybe_autocheckpoint()
        return version

    def compact_incremental(self, *, generator=None, draws=None) -> int:
        """Seal the grow segment's live rows into ONE new pooled segment
        (O(grow) build work, counted by ``dispatch.build_rows``), carrying
        their entity rows and dropping its tombstones, at pow2 capacity under
        ``RouterConfig.seal_pow2``. Sealed segments are never touched: their
        tombstones wait for a merge or a full rebuild. Then runs the
        size-tier merge policy when ``auto_merge`` is on."""
        svc = self.service
        with svc._write_lock:
            snap = svc._snap
            if snap.grow is None:
                return snap.version
            pool: SegmentPool = snap.index
            live = np.flatnonzero(snap.grow.alive.cpu().numpy())
            if live.size:
                grow_corpus = _rows(snap.grow.corpus, live)
                gids = snap.grow_gids.cpu().numpy()[live]
                ents = widen_entities(snap.grow.doc_entities.cpu().numpy()[live],
                                      pool.entity_width)
                generator, draws = self._randomness(SEAL_SALT, int(live.size), generator, draws)
                capacity = _next_pow2(int(live.size)) if self.config.seal_pow2 else int(live.size)
                segment = build_pool_segment(
                    grow_corpus, gids, self.build_cfg, capacity=capacity, generator=generator,
                    draws=draws, corpus_dtype=self._corpus_dtype(), device=self._device,
                    **self._kg_kwargs(ents))
                pool, _ = append_segment(pool, segment)
            # (every grow doc tombstoned: dropping the grow segment IS the
            # compaction)
            svc._publish(pool, grow=None, grow_gids=None)
            self._grow_raw = None
            self.stats._compactions.inc(mode="incremental")
            version = svc._snap.version
        if self.config.auto_merge:
            if self.config.background_merge:
                self._notify_merge_worker()
            else:
                self.maybe_merge_segments()
                version = svc._snap.version
        self._maybe_autocheckpoint()
        return version

    def merge_segments(self, a: tuple[int, int], b: tuple[int, int], *, generator=None,
                       draws=None) -> int:
        """Coalesce two pooled segments, (group, segment-in-group) pairs,
        into one: their LIVE docs rebuilt as one segment (tombstones
        reclaimed), the two removed. O(live docs of a + b); every group not
        holding a or b keeps its key."""
        with self.service._write_lock:
            return self._merge_segments_locked(a, b, generator=generator, draws=draws)

    def _merge_segments_locked(self, a, b, *, generator=None, draws=None) -> int:
        svc = self.service
        if a == b:
            raise ValueError("cannot merge a segment with itself")
        snap = svc._snap
        pool: SegmentPool = snap.index
        for g, s in (a, b):
            if g >= pool.n_groups or s >= pool.groups[g].n_segments:
                raise ValueError(f"no pooled segment ({g}, {s})")
        ca, ga, ea = extract_segment_docs(pool, *a)
        cb, gb, eb = extract_segment_docs(pool, *b)
        width = max(ea.shape[-1], eb.shape[-1])
        corpus = cat_fused([ca, cb])
        gids = np.concatenate([ga, gb])
        ents = np.concatenate([widen_entities(ea, width), widen_entities(eb, width)], axis=0)
        pool = remove_segments(pool, [a, b])
        if corpus.n == 0:
            # both segments fully tombstoned: removal is the merge
            if not pool.groups:
                return snap.version  # never publish an empty pool
        else:
            generator, draws = self._randomness(MERGE_SALT, corpus.n, generator, draws)
            capacity = _next_pow2(int(corpus.n)) if self.config.seal_pow2 else int(corpus.n)
            merged = build_pool_segment(
                corpus, gids, self.build_cfg, capacity=capacity, generator=generator,
                draws=draws, corpus_dtype=self._corpus_dtype(), device=self._device,
                **self._kg_kwargs(ents))
            pool, _ = append_segment(pool, merged)
        svc._publish(pool, grow=snap.grow, grow_gids=snap.grow_gids)
        self.stats._merges.inc()
        return svc._snap.version

    def maybe_merge_segments(self, *, generator=None, draws=None) -> int:
        """Enforce the size-tiered invariant: at most ``tier_fanout``
        segments per pow2-capacity tier. While a tier is over, merge its two
        segments with the fewest live docs (merges migrate small segments up
        the tiers: O(log corpus) merge work per doc over its lifetime). Each
        pick-and-merge runs atomically under the write lock. Returns the
        number of merges."""
        merges = 0
        while True:
            with self.service._write_lock:
                snap = self.service._snap
                tiers: dict[int, list[tuple[int, int, int]]] = {}
                for g, s, cap, live in live_counts(snap.index):
                    tiers.setdefault(max(cap, 1).bit_length(), []).append((live, g, s))
                offending = [m for m in tiers.values() if len(m) > self.config.tier_fanout]
                if not offending:
                    return merges
                members = sorted(offending[0])
                a, b = members[0][1:], members[1][1:]
                v0 = snap.version
                self._merge_segments_locked(a, b, generator=generator, draws=draws)
                if self.service._snap.version == v0:
                    return merges  # merge declined (would empty the pool)
            merges += 1

    # -- background merge worker --------------------------------------------

    def _notify_merge_worker(self) -> None:
        """Wake (starting lazily if needed) the background merge worker. The
        worker is a second host thread launching device work; each merge
        takes the write lock and its publish synchronises the device first,
        so readers only ever pick up finished tensors."""
        with self._merge_lock:
            if self._merge_thread is None or not self._merge_thread.is_alive():
                self._merge_stop.clear()
                self._merge_thread = threading.Thread(
                    target=self._merge_loop, name="segment-router-merge", daemon=True)
                self._merge_thread.start()
            self._merge_wake.set()

    def _merge_loop(self) -> None:
        while True:
            self._merge_wake.wait()
            if self._merge_stop.is_set():
                return
            # drop idle BEFORE consuming the wake flag, so a pending merge
            # always shows as wake-set or idle-clear to wait_merges()
            self._merge_idle.clear()
            self._merge_wake.clear()
            try:
                self.maybe_merge_segments()
            finally:
                self._merge_idle.set()

    def wait_merges(self, timeout_s: float = 120.0) -> None:
        """Block until the merge policy is quiescent: no pending wake-up and
        no merge cascade in flight."""
        deadline = time.monotonic() + timeout_s
        while self._merge_wake.is_set() or not self._merge_idle.is_set():
            if self._merge_stop.is_set():
                return
            if time.monotonic() > deadline:
                raise TimeoutError(f"merge worker still busy after {timeout_s}s")
            time.sleep(0.005)

    def stop_merge_worker(self, timeout_s: float = 60.0) -> None:
        """Join the merge worker (idempotent; ``stop_pump`` calls it). An
        in-flight policy run finishes first, so no merge is torn."""
        with self._merge_lock:
            thread = self._merge_thread
            if thread is None:
                return
            self._merge_stop.set()
            self._merge_wake.set()
            thread.join(timeout=timeout_s)
            self._merge_thread = None
            self._merge_wake.clear()
            self._merge_stop.clear()

    # -- auto-checkpoint ----------------------------------------------------

    def _maybe_autocheckpoint(self) -> None:
        """Persist the sealed pool, paired with the fitted ingest pipeline
        when the router has one, every ``autocheckpoint_every``
        compactions, so a crash loses at most the current grow segment plus
        one window. Runs outside the write lock (a published snapshot is
        immutable) and serializes writers on its own lock."""
        cfg = self.config
        if cfg.autocheckpoint_every <= 0 or cfg.autocheckpoint_dir is None:
            return
        with self._ckpt_lock:
            done = self.stats.compactions
            if done - self._last_ckpt_compactions < cfg.autocheckpoint_every:
                return
            from repro_torch.checkpoint.index_io import save_pool

            save_pool(cfg.autocheckpoint_dir, self.pool, ingest=self._ingest)
            self._last_ckpt_compactions = done
            self.stats._autocheckpoints.inc()
