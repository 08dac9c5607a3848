"""Batched hybrid-search serving engine. Port of
``repro/serving/hybrid_service.py`` over one device.

``HybridSearchService`` is the online request path:

  * heterogeneous requests (any ``FusionSpec``, optional keywords/entities,
    any ``k <= params.k``) are micro-batched into fixed shape buckets by
    ``serving.batcher``: batch padded to a power of two, keyword/entity
    widths padded to bucket caps;
  * every bucket is keyed on ``(index shape key, bucket, SearchParams)``.
    ``repro`` AOT-compiles an XLA executable per key; PyTorch runs eagerly
    and compiles nothing, so the service only records the keys it has seen.
    The hit/miss counter ``allanpoe_serving_executable_cache_total`` keeps
    its meaning, and ``stats.new_shape_keys`` counts the misses (``repro``'s
    ``stats.compiles``): fusion mode and weights are (B,) tensors, never part
    of the key, so one key serves every weight mix;
  * ``insert`` / ``mark_deleted`` go through a copy-on-write snapshot swap:
    the writer builds the next index off to the side and publishes it
    atomically, so in-flight batches never see a half-updated index;
  * the same service fronts a single ``HybridIndex``, a ``SegmentPool`` and,
    over a device mesh, a ``SegmentedIndex``: a pool read runs
    ``make_local_group_search`` once per shape group and merges the groups
    per row in global-id space, fusion-aware; a group that shards over the
    mesh (``core.segment_pool.pool_placement``), and a ``SegmentedIndex``
    always, runs ``make_distributed_search_padded`` instead;
  * a pool snapshot may carry a *grow segment* (a small ``HybridIndex``
    absorbing streaming inserts, managed by ``serving.segment_router``):
    reads also run ``search_padded`` over it and merge per row in global-id
    space. The grow pass's shape keys are kept apart from the sealed keys,
    so grow churn never prunes or adds a sealed key;
  * token-bucket admission control runs in front of ``MicroBatcher.enqueue``;
    a background pump thread drives ``poll`` so deadline flushes do not
    depend on the submit path.

Writes to a pool go through an attached ``SegmentRouter``.

Over a mesh (``HybridSearchService(..., mesh=)``) the service runs on rank
0, the controller: it owns the batcher, the pump, the router and every
write. Every other rank calls ``follow(mesh)``, which blocks until the
controller announces the end (``HybridSearchService.stop_followers``, also
run by ``close`` and on leaving a ``with`` block). Each collective the
controller starts (a search of a sharded group with the bucket's queries,
fusion rows, keywords and entities; the shipping of a newly placed group's
blocks to the ranks that own them; a full compaction) is first announced by
a broadcast on the world group, then joined by every rank. Groups that do
not shard are searched by rank 0 alone, unannounced. All of rank 0's
collectives run under one lock, and an idle controller announces a
keep-alive every quarter of the mesh's timeout, so a follower whose
controller stopped or failed raises within that timeout instead of hanging,
and so does a controller whose follower failed.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.build_pipeline import BuildDraws
from repro_torch.core.build_pipeline import insert as index_insert
from repro_torch.core.distributed import (
    SEGMENT_AXES,
    SegmentedIndex,
    compact_segmented_index,
    make_distributed_search_padded,
    make_local_group_search,
    mesh_segment_count,
    place_segmented_index,
)
from repro_torch.core.fusion import (
    FUSION_MODE_NAMES,
    FusionSpec,
    PathStats,
    as_fusion_spec,
    merge_fused_host,
    stack_specs,
)
from repro_torch.core.index import INDEX_FIELDS, BuildConfig, HybridIndex
from repro_torch.core.index import mark_deleted as index_mark_deleted
from repro_torch.core.search import SearchParams, SearchResult, resolve_params, search_padded
from repro_torch.core.segment_pool import (
    SegmentPool,
    group_shape_key,
    group_shards,
    place_pool,
    pool_placement,
)
from repro_torch.core.usms import (
    PAD_IDX,
    FusedVectors,
    PathWeights,
    QuantizedFusedVectors,
    SparseVec,
    corpus_nbytes_by_leaf,
    dtype_name,
    quantize_corpus,
)
from repro_torch.launch.mesh import (
    axis_coordinate,
    broadcast_object,
    broadcast_tensors,
    mesh_device,
    mesh_timeout_s,
    recv_tensors,
    send_tensors,
    tensor_specs,
)
from repro_torch.obs.export import write_metrics_snapshot
from repro_torch.obs.metrics import GLOBAL as GLOBAL_METRICS
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.tracer import TraceContext, Tracer, tracing
from repro_torch.serving.batcher import (
    AdmissionConfig,
    AdmissionController,
    AdmissionError,
    BatcherConfig,
    Bucket,
    MicroBatcher,
    PendingResult,
    QueueFullError,
    SearchRequest,
)

# process-wide storage-footprint gauges, set at every snapshot publish (and
# at construction). Labels: leaf kind x storage dtype, so the quantized
# compression ratio is a scraped metric. With several services in one
# process the most recent publisher wins.
_INDEX_BYTES = GLOBAL_METRICS.gauge(
    "allanpoe_index_bytes_total",
    "served index storage bytes by leaf kind and dtype",
    labels=("leaf", "dtype"),
)


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    batcher: BatcherConfig = BatcherConfig()
    admission: Optional[AdmissionConfig] = None  # token buckets before enqueue
    pump_interval_s: Optional[float] = None  # auto-start a poll() pump thread
    # observability (DESIGN.md §12): share a registry/tracer across services
    # by passing them in; None gives the service its own private ones
    metrics: Optional[MetricsRegistry] = None
    tracer: Optional[Tracer] = None
    # periodic JSON snapshot flush from the pump thread (service registry +
    # the process-global one), every _METRICS_DUMP_INTERVAL_S; None disables
    metrics_dump_path: Optional[str] = None


_METRICS_DUMP_INTERVAL_S = 10.0


def _bucket_label(bucket: Bucket) -> str:
    return f"{bucket.batch}x{bucket.kw_width}x{bucket.ent_width}"


def _fusion_mode_label(spec) -> str:
    """Host-side fusion-mode label of a request spec ("batched" for (B,)
    leaf specs)."""
    try:
        mode = spec.mode
        if np.ndim(mode) >= 1:
            return "batched"
        return FUSION_MODE_NAMES.get(int(mode), str(int(mode)))
    except (TypeError, ValueError, AttributeError):
        return "unknown"


def _spec_row(spec: FusionSpec, i: int) -> FusionSpec:
    """Row i of a batched (B,)-leaf spec."""
    st = spec.stats
    return FusionSpec(
        mode=spec.mode[i],
        weights=PathWeights(*(torch.as_tensor(getattr(spec.weights, f))[i]
                              for f in ("dense", "sparse", "full", "kg"))),
        rrf_k=spec.rrf_k[i],
        stats=None if st is None else PathStats(st.minv[i], st.maxv[i], st.mean[i], st.std[i]),
    )


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


class ServiceStats:
    """Thread-safe service counters backed by the metrics registry (every
    increment goes through the registry's single lock); the properties
    report totals. ``new_shape_keys`` stands where ``repro``'s ``compiles``
    does: eager PyTorch compiles nothing, so it counts the batches that met
    a new (index key, bucket, params) key."""

    def __init__(self, metrics: MetricsRegistry):
        self._requests = metrics.counter(
            "allanpoe_serving_requests_total",
            "requests admitted and enqueued (rejects counted separately)",
            labels=("mode",),
        )
        self._batches = metrics.counter(
            "allanpoe_serving_batches_total", "batches executed", labels=("bucket",)
        )
        self._new_shape_keys = metrics.counter(
            "allanpoe_serving_new_shape_keys_total",
            "first batches per index key x bucket x params (repro's compiles)",
        )
        self._padded_slots = metrics.counter(
            "allanpoe_serving_padded_slots_total", "wasted batch slots (padding overhead measure)"
        )
        self._rejected = metrics.counter(
            "allanpoe_serving_rejected_total",
            "rejected submits by reason (admission = rate policy, queue_full = backpressure)",
            labels=("reason",),
        )

    @property
    def requests(self) -> int:
        return int(self._requests.total())

    @property
    def batches(self) -> int:
        return int(self._batches.total())

    @property
    def new_shape_keys(self) -> int:
        """Batches that met a new (index key, bucket, params) key: what
        ``repro``'s ``stats.compiles`` counts. Eager PyTorch compiles
        nothing."""
        return int(self._new_shape_keys.total())

    @property
    def padded_slots(self) -> int:
        return int(self._padded_slots.total())

    @property
    def rejected_queue_full(self) -> int:
        return int(self._rejected.value(reason="queue_full"))

    @property
    def rejected_admission(self) -> int:
        return int(self._rejected.value(reason="admission"))

    @property
    def rejected(self) -> int:
        return self.rejected_queue_full + self.rejected_admission

    def __repr__(self) -> str:
        return (
            f"ServiceStats(requests={self.requests}, batches={self.batches}, "
            f"new_shape_keys={self.new_shape_keys}, padded_slots={self.padded_slots}, "
            f"rejected_queue_full={self.rejected_queue_full}, "
            f"rejected_admission={self.rejected_admission})"
        )


@dataclasses.dataclass(frozen=True)
class _Snapshot:
    """An immutable index the read path holds across a whole batch — the
    copy-on-write unit. ``grow``/``grow_gids`` are a pool's optional grow
    segment and its local-row -> global-id map."""

    index: Union[HybridIndex, SegmentedIndex, SegmentPool]
    version: int
    grow: Optional[HybridIndex] = None
    grow_gids: Optional[torch.Tensor] = None  # (n_grow,) int32


def _index_device(index) -> torch.device:
    if isinstance(index, SegmentPool):
        return index.groups[0].global_ids.device
    if isinstance(index, SegmentedIndex):
        return index.global_ids.device
    return index.semantic_edges.device


# ---------------------------------------------------------------------------
# Mesh-fronted serving: rank 0 controls, every other rank follows
# ---------------------------------------------------------------------------

_SEARCH, _PLACE, _COMPACT, _PING, _STOP = "search", "place", "compact", "ping", "stop"


def _flat_args(args) -> list[torch.Tensor]:
    """A batch's (queries, fusion, keywords, entities) as 17 tensors."""
    queries, spec, kw, ent = args
    w, st = spec.weights, spec.stats
    return [*queries.tensors(), spec.mode, w.dense, w.sparse, w.full, w.kg, spec.rrf_k,
            st.minv, st.maxv, st.mean, st.std, kw, ent]


def _args_from_flat(ts):
    queries = FusedVectors(ts[0], SparseVec(ts[1], ts[2]), SparseVec(ts[3], ts[4]))
    spec = FusionSpec(mode=ts[5], weights=PathWeights(*ts[6:10]), rrf_k=ts[10],
                      stats=PathStats(*ts[11:15]))
    return queries, spec, ts[15], ts[16]


def _segmented_from_leaves(leaves) -> SegmentedIndex:
    """Inverse of ``SegmentedIndex.leaves()``: 5 corpus tensors make an fp32
    corpus, 6 an int8 one."""
    nc = len(leaves) - len(INDEX_FIELDS) - 1
    c = leaves[:nc]
    corpus = (FusedVectors(c[0], SparseVec(c[1], c[2]), SparseVec(c[3], c[4])) if nc == 5
              else QuantizedFusedVectors(c[0], c[1], SparseVec(c[2], c[3]),
                                         SparseVec(c[4], c[5])))
    fields = dict(zip(INDEX_FIELDS, leaves[nc:-1]))
    return SegmentedIndex(HybridIndex(corpus=corpus, **fields), leaves[-1])


def _compact(mesh, tensors, n_segments, cfg, seed, corpus_dtype, kg_kwargs):
    """A full compaction over the mesh, as every rank runs it: the build
    (collective), then the seal-time quantization."""
    corpus = FusedVectors(tensors[0], SparseVec(tensors[1], tensors[2]),
                          SparseVec(tensors[3], tensors[4]))
    seg = compact_segmented_index(corpus, tensors[5].cpu().numpy(), n_segments, cfg, mesh=mesh,
                                  seed=seed, **kg_kwargs)
    if corpus_dtype == "int8":  # builds are always fp32; sealed storage quantizes here
        seg = SegmentedIndex(dataclasses.replace(
            seg.index, corpus=quantize_corpus(seg.index.corpus)), seg.global_ids)
    return seg


class _MeshFront:
    """Rank 0's side of a mesh-fronted service. Announces every collective
    to the followers, keeps the groups that shard placed on the ranks that
    own their segments (a group's blocks are shipped once, leaves already
    shipped are reused), and runs the distributed search. Every collective
    runs under ``lock``."""

    def __init__(self, mesh, params: SearchParams):
        if not dist.is_initialized():
            raise RuntimeError(
                "a mesh-fronted service needs the mesh's process group (launch.mesh.make_mesh)")
        if dist.get_rank() != 0:
            raise ValueError(
                f"rank {dist.get_rank()} is a follower: the service runs on rank 0, every "
                "other rank calls serving.hybrid_service.follow(mesh)")
        self.mesh, self.params = mesh, params
        self.msc = mesh_segment_count(mesh)
        self.dist_fn = make_distributed_search_padded(mesh, params)
        self.lock = threading.RLock()
        self._tokens = 0
        # id(group) -> (token, group, rank 0's block); the group held so its
        # id stays unique while it is placed
        self._placed: dict[int, tuple[int, SegmentedIndex, SegmentedIndex]] = {}
        self._last = time.monotonic()
        self._stopped = False
        self._idle_s = mesh_timeout_s(mesh) / 4
        self._keepalive_stop = threading.Event()
        self._keepalive = threading.Thread(target=self._keep_alive, name="mesh-keepalive",
                                           daemon=True)
        self._keepalive.start()

    def _announce(self, op) -> None:
        if self._stopped:
            raise RuntimeError("the mesh front was stopped: its followers have left")
        broadcast_object(op)
        self._last = time.monotonic()

    def _keep_alive(self) -> None:
        while not self._keepalive_stop.wait(self._idle_s):
            with self.lock:
                if self._stopped:
                    return
                if time.monotonic() - self._last >= self._idle_s:
                    self._announce((_PING,))

    def _ensure(self, pairs, drop_others: bool) -> None:
        """Place every (group, rank 0's block) pair not yet placed: one
        announcement, then each follower receives the leaves of its block
        that no placed group holds already. With ``drop_others``, groups not
        listed are dropped."""
        new = [(g, b) for g, b in pairs if id(g) not in self._placed]
        listed = {id(g) for g, _ in pairs}
        drop = [gid for gid in self._placed if gid not in listed] if drop_others else []
        if not new and not drop:
            return
        known = {id(leaf): (tok, j) for tok, g, _ in self._placed.values()
                 for j, leaf in enumerate(g.leaves())}
        plan = []
        for g, _ in new:
            self._tokens += 1
            leaves = g.leaves()
            how = [("keep",) + known[id(t)] if id(t) in known else ("recv",) for t in leaves]
            plan.append((self._tokens, g.n_segments, tensor_specs(leaves), how))
        self._announce((_PLACE, plan, [self._placed[gid][0] for gid in drop]))
        for r in range(1, dist.get_world_size()):
            c = axis_coordinate(self.mesh, SEGMENT_AXES, r)
            for (g, _), (_, n, _, how) in zip(new, plan):
                spd = n // self.msc
                send_tensors(self.mesh, [t[c * spd:(c + 1) * spd] for t, h in
                                         zip(g.leaves(), how) if h[0] == "recv"], dst=r)
        for gid in drop:
            del self._placed[gid]
        for (g, block), (tok, _, _, _) in zip(new, plan):
            self._placed[id(g)] = (tok, g, block)

    def place(self, index) -> None:
        """Place the groups of a snapshot about to be published that run
        sharded (a ``SegmentedIndex`` always; a pool's per ``place_pool``),
        and drop every other group's blocks."""
        if isinstance(index, SegmentedIndex):
            pairs = [(index, place_segmented_index(index, self.mesh))]
        elif isinstance(index, SegmentPool):
            placed = place_pool(index, self.mesh)
            pairs = [(g, b) for g, b, pl in zip(index.groups, placed.groups,
                                                pool_placement(index, self.mesh)) if pl.sharded]
        else:
            pairs = []
        with self.lock:
            self._ensure(pairs, drop_others=True)

    def search(self, group: SegmentedIndex, args) -> SearchResult:
        """Announce the batch, then search the group over the mesh. A group
        dropped by a publish since the batch took its snapshot is placed
        again first."""
        dev = mesh_device(self.mesh)
        flat = [torch.as_tensor(t).to(dev) for t in _flat_args(args)]
        with self.lock:
            if id(group) not in self._placed:
                self._ensure([(group, place_segmented_index(group, self.mesh))], False)
            tok, _, block = self._placed[id(group)]
            specs = tensor_specs(flat)
            self._announce((_SEARCH, tok, self.params, specs))
            broadcast_tensors(self.mesh, flat, specs)
            return self.dist_fn(block, *_args_from_flat(flat))

    def compact(self, corpus: FusedVectors, gids: np.ndarray, n_segments: int, cfg,
                seed: int, corpus_dtype: str, kg_kwargs: dict) -> SegmentedIndex:
        """A full compaction built over the mesh (collective). The result's
        blocks stay on the ranks that built them."""
        dev = mesh_device(self.mesh)
        tensors = [t.to(dev) for t in corpus.tensors()] + [
            torch.as_tensor(np.asarray(gids, np.int32), device=dev)]
        with self.lock:
            self._tokens += 1
            tok = self._tokens
            specs = tensor_specs(tensors)
            self._announce((_COMPACT, tok, n_segments, cfg, seed, corpus_dtype, kg_kwargs, specs))
            broadcast_tensors(self.mesh, tensors, specs)
            seg = _compact(self.mesh, tensors, n_segments, cfg, seed, corpus_dtype, kg_kwargs)
            if group_shards(seg.n_segments, self.mesh):
                self._placed[id(seg)] = (tok, seg, place_segmented_index(seg, self.mesh))
            return seg

    def stop(self) -> None:
        """Announce the end to the followers (idempotent)."""
        self._keepalive_stop.set()
        with self.lock:
            if not self._stopped:
                self._announce((_STOP,))
                self._stopped = True
        if self._keepalive is not threading.current_thread():
            self._keepalive.join(timeout=5.0)


def follow(mesh) -> int:
    """Follow the mesh-fronted service of rank 0 (every rank but 0 calls
    this with the mesh it made): join each collective the controller
    announces, with this rank's block of each placed group, until the
    controller announces the end (``HybridSearchService.stop_followers``,
    run by ``close``). Returns the number of searches joined. A controller
    silent past the mesh's timeout makes this raise, never hang."""
    if dist.get_rank() == 0:
        raise ValueError("rank 0 is the controller: it serves through HybridSearchService")
    msc = mesh_segment_count(mesh)
    blocks: dict[int, SegmentedIndex] = {}
    fns: dict = {}
    searches = 0
    while True:
        op = broadcast_object(None)
        kind = op[0]
        if kind == _STOP:
            return searches
        if kind == _SEARCH:
            _, tok, params, specs = op
            flat = broadcast_tensors(mesh, None, specs)
            if params not in fns:
                fns[params] = make_distributed_search_padded(mesh, params)
            fns[params](blocks[tok], *_args_from_flat(flat))
            searches += 1
        elif kind == _PLACE:
            _, plan, drop = op
            for tok, n, specs, how in plan:
                spd = n // msc
                got = iter(recv_tensors(mesh, [((spd,) + shape[1:], dt) for (shape, dt), h
                                               in zip(specs, how) if h[0] == "recv"]))
                blocks[tok] = _segmented_from_leaves(
                    [next(got) if h[0] == "recv" else blocks[h[1]].leaves()[h[2]] for h in how])
            for tok in drop:
                blocks.pop(tok, None)
        elif kind == _COMPACT:
            _, tok, n_segments, cfg, seed, corpus_dtype, kg_kwargs, specs = op
            tensors = broadcast_tensors(mesh, None, specs)
            seg = _compact(mesh, tensors, n_segments, cfg, seed, corpus_dtype, kg_kwargs)
            if group_shards(n_segments, mesh):
                blocks[tok] = place_segmented_index(seg, mesh)
        elif kind != _PING:
            raise RuntimeError(f"unknown announcement {kind!r}")


class HybridSearchService:
    """Micro-batched serving front-end over a hybrid index snapshot."""

    def __init__(
        self,
        index: Union[HybridIndex, SegmentedIndex, SegmentPool],
        params: SearchParams,
        config: Optional[ServiceConfig] = None,
        *,
        mesh=None,
        build_cfg: Optional[BuildConfig] = None,
    ):
        """``mesh`` (a ``launch.mesh.make_mesh`` mesh): serve from rank 0,
        the controller, with every other rank in ``follow(mesh)``. A
        ``SegmentedIndex`` is served only over a mesh (wrap it with
        ``SegmentPool.from_segmented`` to serve it on one device)."""
        if isinstance(index, SegmentedIndex):
            if mesh is None:
                raise ValueError("a SegmentedIndex service requires a mesh")
            if index.n_segments % mesh_segment_count(mesh):
                raise ValueError(
                    f"{index.n_segments} segments do not divide over the mesh's "
                    f"{mesh_segment_count(mesh)} segment devices")
        self.params = resolve_params(params)
        # declared storage must match what the index holds: quantized
        # segments under corpus_dtype="float32" would be served under a key
        # that does not describe them. "int8" over (still) fp32 groups is
        # allowed: old fp32 seals may coexist with new int8 ones.
        if self.params.corpus_dtype == "float32":
            quantized = [c for c, _ in self._norm_parts(_Snapshot(index, version=0))
                         if isinstance(c, QuantizedFusedVectors)]
            if quantized:
                raise ValueError(
                    "index holds quantized corpus storage but SearchParams.corpus_dtype is "
                    '"float32"; construct the service with corpus_dtype="int8"'
                )
        self.config = config or ServiceConfig()
        self.metrics = self.config.metrics or MetricsRegistry()
        self.tracer = self.config.tracer or Tracer()
        self.stats = ServiceStats(self.metrics)
        self._m_exec_cache = self.metrics.counter(
            "allanpoe_serving_executable_cache_total",
            "index key x bucket x params lookups by outcome (repro's AOT cache)",
            labels=("outcome",),
        )
        self._m_group_dispatch = self.metrics.counter(
            "allanpoe_serving_group_dispatches_total",
            "pool-read dispatches per segment shape group",
            labels=("group",),
        )
        self._m_queue_depth = self.metrics.gauge(
            "allanpoe_serving_queue_depth", "pending requests in the batcher"
        )
        self._m_queue_wait = self.metrics.histogram(
            "allanpoe_serving_queue_wait_seconds", "enqueue -> batch start per request"
        )
        self._m_latency = self.metrics.histogram(
            "allanpoe_serving_request_latency_seconds",
            "enqueue -> result delivery per request (the bench p50/p99 source)",
        )
        self._m_batch_exec = self.metrics.histogram(
            "allanpoe_serving_batch_exec_seconds", "assemble -> deliver per batch",
            labels=("bucket",),
        )
        self._snap = _Snapshot(index, version=0)
        self._index_bytes_keys: set = set()
        self._tick_index_bytes(self._snap)
        self._write_lock = threading.Lock()  # serializes snapshot writers
        # queue lock: enqueue/take_ready only, never held across a batch run
        self._queue_lock = threading.Lock()
        # key lock: every _seen_keys check-and-add and prune
        self._key_lock = threading.Lock()
        self._batcher = MicroBatcher(self.config.batcher)
        self._seen_keys: set = set()
        # shape keys the grow pass has read (repro's search_padded traces):
        # never pruned, kept apart from the sealed keys
        self._grow_keys: set = set()
        self._pool = isinstance(index, SegmentPool)
        self._segmented = self._pool or isinstance(index, SegmentedIndex)
        self._local_fn = make_local_group_search(self.params) if self._segmented else None
        self._mesh = mesh
        self._front = _MeshFront(mesh, self.params) if mesh is not None else None
        if self._front is not None:
            self._front.place(index)
        self._build_cfg = build_cfg
        self._router = None  # set by serving.segment_router.SegmentRouter
        # running per-path normalization stats: refreshed lazily when the
        # snapshot version moves, EMA-blended across publishes (DESIGN.md §11)
        self._stats_cache: Optional[PathStats] = None
        self._stats_version = -1
        self._admission = (
            AdmissionController(self.config.admission)
            if self.config.admission is not None else None
        )
        self._pump_lock = threading.Lock()  # guards pump start/stop
        self._pump_thread: Optional[threading.Thread] = None
        self._pump_stop = threading.Event()
        if self.config.pump_interval_s is not None:
            self.start_pump()

    # -- background pump (flush-on-deadline without a submit) ---------------

    def start_pump(self, interval_s: Optional[float] = None) -> None:
        """Start the daemon thread that drives ``poll()`` every
        ``interval_s`` (default: ``config.pump_interval_s``). Idempotent."""
        interval = self.config.pump_interval_s if interval_s is None else interval_s
        if interval is None:
            raise ValueError("pump interval required (arg or config)")
        with self._pump_lock:  # check-then-start is atomic: exactly one pump
            if self._pump_thread is not None and self._pump_thread.is_alive():
                return
            self._pump_stop = threading.Event()
            stop = self._pump_stop

            def loop():
                last_dump = time.monotonic()
                while not stop.wait(interval):
                    try:
                        self.poll()
                    except Exception:  # noqa: BLE001 - the pump must keep pumping
                        pass  # the failing batch already failed its own waiters
                    if (self.config.metrics_dump_path is not None
                            and time.monotonic() - last_dump
                            >= _METRICS_DUMP_INTERVAL_S):
                        last_dump = time.monotonic()
                        try:
                            self.dump_metrics()
                        except OSError:
                            pass  # a full disk must not kill the pump

            self._pump_thread = threading.Thread(
                target=loop, name="hybrid-service-pump", daemon=True)
            self._pump_thread.start()

    def dump_metrics(self, path=None) -> dict:
        """Write the merged (service + process-global) metrics snapshot to
        ``path`` (default ``config.metrics_dump_path``); returns the dict."""
        path = self.config.metrics_dump_path if path is None else path
        if path is None:
            raise ValueError("no metrics dump path (arg or config)")
        return write_metrics_snapshot(path, self.metrics, GLOBAL_METRICS)

    def stop_pump(self, timeout_s: float = 5.0) -> None:
        with self._pump_lock:
            thread = self._pump_thread
            if thread is not None:
                self._pump_stop.set()
                thread.join(timeout=timeout_s)
                self._pump_thread = None
                if self.config.metrics_dump_path is not None:
                    try:
                        self.dump_metrics()  # final flush on clean shutdown
                    except OSError:
                        pass
        # clean shutdown extends to the attached router's merge worker: an
        # in-flight merge finishes its publish, then the worker exits
        if self._router is not None:
            self._router.stop_merge_worker()

    def stop_followers(self) -> None:
        """Announce the end to the followers of a mesh-fronted service: each
        ``follow(mesh)`` returns. Idempotent; a no-op off the mesh. Every
        read or write that needs the mesh raises afterwards."""
        if self._front is not None:
            self._front.stop()

    def close(self) -> None:
        """Stop the pump (and the router's merge worker), then the
        followers."""
        self.stop_pump()
        self.stop_followers()

    def __enter__(self) -> "HybridSearchService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- snapshot management (copy-on-write swap) ---------------------------

    @property
    def snapshot_version(self) -> int:
        return self._snap.version

    @property
    def index(self) -> Union[HybridIndex, SegmentedIndex, SegmentPool]:
        return self._snap.index

    @property
    def grow_index(self) -> Optional[HybridIndex]:
        """The current grow segment (None when sealed-only)."""
        return self._snap.grow

    @property
    def grow_shape_keys(self) -> set:
        """Every grow-segment shape key a read has run over (pow2 bucketing
        keeps it O(log growth) between compactions)."""
        return self._grow_keys

    # EMA weight of FRESH stats at each snapshot publish
    _STATS_EMA = 0.3

    @staticmethod
    def _norm_parts(snap: _Snapshot):
        """(corpus, alive) pairs covering every row of a snapshot."""
        idx = snap.index
        if isinstance(idx, SegmentPool):
            parts = [(g.index.corpus, g.index.alive) for g in idx.groups]
        elif isinstance(idx, SegmentedIndex):
            parts = [(idx.index.corpus, idx.index.alive)]
        else:
            parts = [(idx.corpus, idx.alive)]
        if snap.grow is not None:
            parts.append((snap.grow.corpus, snap.grow.alive))
        return parts

    @property
    def path_stats(self) -> PathStats:
        """Running per-path normalization stats of the served corpus ((3,)
        leaves), refreshed when the snapshot version moves."""
        snap = self._snap
        if self._stats_cache is None or self._stats_version != snap.version:
            fresh = PathStats.from_corpus_parts(self._norm_parts(snap))
            stats = (fresh if self._stats_cache is None
                     else PathStats.ema(self._stats_cache, fresh, self._STATS_EMA))
            self._stats_cache, self._stats_version = stats, snap.version
        return self._stats_cache

    def _resolve_spec(self, spec: FusionSpec) -> FusionSpec:
        """Pin unresolved (stats=None) specs to the service's running stats."""
        if spec.stats is not None:
            return spec
        return dataclasses.replace(spec, stats=self.path_stats)

    def _tick_index_bytes(self, snap: _Snapshot) -> None:
        """Set the ``allanpoe_index_bytes_total{leaf,dtype}`` gauges to this
        snapshot's storage footprint: corpus leaves by kind (dense /
        dense_scale / sparse_idx / sparse_val), everything else as "graph"
        by dtype. Label pairs that vanished are zeroed, not left stale."""
        totals: dict = {}

        def add(leaf: str, t: torch.Tensor) -> None:
            key = (leaf, dtype_name(t))
            totals[key] = totals.get(key, 0) + t.numel() * t.element_size()

        def add_index(hidx: HybridIndex) -> None:
            for key, v in corpus_nbytes_by_leaf(hidx.corpus).items():
                totals[key] = totals.get(key, 0) + v
            for f in INDEX_FIELDS:
                add("graph", getattr(hidx, f))

        idx = snap.index
        if isinstance(idx, SegmentPool):
            for g in idx.groups:
                add_index(g.index)
                add("graph", g.global_ids)
        elif isinstance(idx, SegmentedIndex):
            add_index(idx.index)
            add("graph", idx.global_ids)
        else:
            add_index(idx)
        if snap.grow is not None:
            add_index(snap.grow)
        for leaf, dtype in self._index_bytes_keys - set(totals):
            _INDEX_BYTES.set(0, leaf=leaf, dtype=dtype)
        for (leaf, dtype), v in totals.items():
            _INDEX_BYTES.set(v, leaf=leaf, dtype=dtype)
        self._index_bytes_keys = set(totals)

    def _publish(self, new_index, *, grow=None, grow_gids=None) -> None:
        """Swap in the next snapshot (callers hold ``_write_lock``). The
        device is synchronised first: work queued by this thread (a build,
        an insert) is finished before any reader can pick the tensors up."""
        dev = _index_device(new_index)
        if grow is not None:
            if grow_gids is None:
                raise ValueError("a grow segment needs its global-id map")
            grow_gids = torch.as_tensor(grow_gids, dtype=torch.int32, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)  # readers never see a half-written index
        if self._front is not None:  # blocks on their ranks before readers see the groups
            self._front.place(new_index)
        self._snap = _Snapshot(new_index, self._snap.version + 1, grow=grow,
                               grow_gids=grow_gids)
        self._tick_index_bytes(self._snap)
        # prune on the SEALED keys only: grow churn neither adds nor evicts
        # them, and a pool publish keeps every group that survived
        valid = self._valid_index_keys(new_index)
        with self._key_lock:
            self._seen_keys = {k for k in self._seen_keys if k[0] in valid}

    def insert(
        self,
        new_docs: FusedVectors,
        *,
        generator: Optional[torch.Generator] = None,
        draws: Optional[BuildDraws] = None,
        new_doc_entities: Optional[np.ndarray] = None,
    ) -> int:
        """Absorb streaming inserts; returns the new snapshot version.
        In-flight searches keep the snapshot they started with. A pool
        service routes inserts to its grow segment through the attached
        ``SegmentRouter``."""
        if self._segmented:
            if self._router is None:
                raise ValueError(
                    "streaming insert into a pool needs a grow segment: attach a "
                    "serving.segment_router.SegmentRouter (to a SegmentedIndex wrapped by "
                    "SegmentPool.from_segmented)")
            return self._router.insert(new_docs, generator=generator, draws=draws,
                                       new_doc_entities=new_doc_entities)
        if self._build_cfg is None:
            raise ValueError("insert requires build_cfg at service construction")
        with self._write_lock:
            new_index = index_insert(self._snap.index, new_docs, self._build_cfg,
                                     generator=generator, draws=draws,
                                     new_doc_entities=new_doc_entities)
            self._publish(new_index)
            return self._snap.version  # read under the lock: OUR version

    def mark_deleted(self, ids) -> int:
        """Mark-delete docs; returns the new snapshot version. Shapes are
        unchanged, so every seen key stays valid. A pool service resolves
        global ids through the attached ``SegmentRouter``."""
        if self._segmented:
            if self._router is None:
                raise ValueError(
                    "deletion on a pool needs global-id routing: attach a "
                    "serving.segment_router.SegmentRouter (to a SegmentedIndex wrapped by "
                    "SegmentPool.from_segmented)")
            return self._router.delete(ids)
        with self._write_lock:
            self._publish(index_mark_deleted(self._snap.index, ids))
            return self._snap.version  # read under the lock: OUR version

    # -- executable-cache keys -----------------------------------------------

    @staticmethod
    def _index_key(index) -> tuple:
        return ("single", type(index.corpus).__name__, index.n)

    def _valid_index_keys(self, index) -> set:
        """Cache keys the given snapshot index can serve."""
        if isinstance(index, SegmentPool):
            return {group_shape_key(g) for g in index.groups}
        if isinstance(index, SegmentedIndex):
            return {group_shape_key(index)}
        return {self._index_key(index)}

    @property
    def executable_cache(self) -> set:
        """The (index/group key, Bucket, SearchParams) keys served so far."""
        return self._seen_keys

    def _lookup(self, index_key: tuple, bucket: Bucket) -> bool:
        """True if the key was served before. Every lookup lands in
        ``allanpoe_serving_executable_cache_total{outcome}``; a miss counts
        as one of ``stats.new_shape_keys``."""
        key = (index_key, bucket, self.params)
        with self._key_lock:
            if key in self._seen_keys:
                self._m_exec_cache.inc(outcome="hit")
                return True
            self._m_exec_cache.inc(outcome="miss")
            if index_key in self._valid_index_keys(self._snap.index):
                self._seen_keys.add(key)
            self.stats._new_shape_keys.inc()
            return False

    # -- request path -------------------------------------------------------

    def _validate(self, request: SearchRequest) -> None:
        bcfg = self.config.batcher
        if request.fusion is None:
            raise ValueError(
                "SearchRequest needs fusion=FusionSpec(...) (or the deprecated "
                "weights=PathWeights form)")
        if request.k > self.params.k:
            raise ValueError(
                f"request.k={request.k} exceeds the service cap params.k={self.params.k}")
        if request.keywords is not None:
            if not self.params.use_keywords:
                raise ValueError("service params have use_keywords=False")
            if len(request.keywords) > bcfg.kw_cap:
                raise ValueError(f"{len(request.keywords)} keywords exceed kw_cap={bcfg.kw_cap}")
        if request.entities is not None:
            if not self.params.use_kg:
                raise ValueError("service params have use_kg=False")
            if len(request.entities) > bcfg.ent_cap:
                raise ValueError(f"{len(request.entities)} entities exceed ent_cap={bcfg.ent_cap}")

    def submit(self, request: SearchRequest) -> PendingResult:
        """Enqueue one request; runs any batch whose flush trigger fired.
        Raises ``AdmissionError`` on a token-bucket reject and
        ``QueueFullError`` on a bounded-queue reject."""
        self._validate(request)
        ctx = request.trace
        t_sub = time.perf_counter()
        pending = PendingResult(service=self)
        with self._queue_lock:
            if self._admission is not None and not self._admission.try_admit(request.tenant):
                self.stats._rejected.inc(reason="admission")
                if ctx is not None:
                    ctx.add_span("admission", t_sub, time.perf_counter(),
                                 outcome="rejected_admission", tenant=request.tenant)
                raise AdmissionError(
                    f"token-bucket admission rejected request (tenant={request.tenant!r}); "
                    "shed load or retry later")
            try:
                self._batcher.enqueue(request, pending)
            except QueueFullError:
                # admitted but never served: hand the tokens back
                if self._admission is not None:
                    self._admission.refund(request.tenant)
                self.stats._rejected.inc(reason="queue_full")
                if ctx is not None:
                    ctx.add_span("admission", t_sub, time.perf_counter(),
                                 outcome="rejected_queue_full", tenant=request.tenant)
                raise
            self.stats._requests.inc(mode=_fusion_mode_label(request.fusion))
            self._m_queue_depth.set(len(self._batcher))
        if ctx is not None:
            ctx.add_span("admission", t_sub, time.perf_counter(),
                         outcome="admitted", tenant=request.tenant)
        try:
            self._drain()
        except Exception:  # noqa: BLE001 - the returned handle is the error channel
            pass  # a failing batch has already failed its own waiters
        return pending

    def poll(self) -> int:
        """Run deadline-due batches; returns the number executed."""
        return self._drain()

    def flush(self) -> int:
        """Force-run every pending batch; returns the number executed."""
        return self._drain(force=True)

    def _drain(self, force: bool = False) -> int:
        with self._queue_lock:
            ready = self._batcher.take_ready(force=force)
            self._m_queue_depth.set(len(self._batcher))
        # run each dequeued batch outside the queue lock; every batch must
        # resolve its waiters even if a sibling failed, so re-raise at the end
        first_err: Optional[BaseException] = None
        for bucket, entries in ready:
            try:
                self._run_batch(bucket, entries)
            except Exception as err:  # noqa: BLE001 - waiters already failed
                first_err = first_err or err
        if first_err is not None:
            raise first_err
        return len(ready)

    def _run_group(self, group: SegmentedIndex, args) -> SearchResult:
        """One group's search: over the mesh when the group shards (a
        ``SegmentedIndex`` snapshot always does), else the local pass."""
        if self._front is not None and (group_shards(group.n_segments, self._mesh)
                                        or not self._pool):
            return self._front.search(group, args)
        return self._local_fn(group, *args)

    def _run_pool(self, pool: SegmentPool, bucket: Bucket, args, phases):
        """Pool read: one group search per shape group, merged per row in
        global-id space. Every group is dispatched before any result is read
        back, so the groups' device work queues back to back."""
        t0 = time.perf_counter()
        hits = [self._lookup(group_shape_key(group), bucket) for group in pool.groups]
        t1 = time.perf_counter()
        results = []
        for gi, group in enumerate(pool.groups):
            self._m_group_dispatch.inc(group=gi)
            results.append(self._run_group(group, args))
        ids_parts = [_host(r.ids) for r in results]
        score_parts = [_host(r.scores) for r in results]
        ps_parts = [_host(r.path_scores) for r in results]
        expanded = sum(_host(r.expanded).astype(np.int64) for r in results)
        t2 = time.perf_counter()
        phases.append(("executable_lookup", t0, t1,
                       {"hit": all(hits), "groups": len(hits)}))
        phases.append(("device_dispatch", t1, t2, {"groups": len(hits)}))
        if len(ids_parts) == 1:
            return ids_parts[0], score_parts[0], ps_parts[0], expanded
        m_ids, m_scores, m_ps = merge_fused_host(
            ids_parts, score_parts, ps_parts, args[1], ids_parts[0].shape[1])
        phases.append(("fusion_rescore", t2, time.perf_counter(),
                       {"parts": len(ids_parts), "site": "pool_merge"}))
        return m_ids, m_scores, m_ps, expanded

    def _merge_grow(self, snap: _Snapshot, args, ids, scores, ps, expanded, phases):
        """Phase two of a pool read: search the grow segment and merge per
        row with the sealed results in global-id space. Tombstones need no
        filter here: both passes filter on their own ``alive`` masks."""
        t0 = time.perf_counter()
        key = self._index_key(snap.grow)
        with self._key_lock:
            retraced = key not in self._grow_keys
            self._grow_keys.add(key)
        gres = search_padded(snap.grow, *args, self.params)
        g_local = _host(gres.ids)
        gmap = _host(snap.grow_gids)
        g_ids = np.where(g_local >= 0, gmap[np.clip(g_local, 0, gmap.shape[0] - 1)], PAD_IDX)
        g_scores = np.where(g_local >= 0, _host(gres.scores), -np.inf)
        g_ps = np.where((g_local >= 0)[:, :, None], _host(gres.path_scores), 0.0)
        m_ids, m_scores, m_ps = merge_fused_host(
            [ids, g_ids], [scores, g_scores], [ps, g_ps], args[1], ids.shape[1])
        phases.append(("grow_merge", t0, time.perf_counter(),
                       {"grow_rows": int(snap.grow.n), "retraced": retraced}))
        return m_ids, m_scores, m_ps, expanded + _host(gres.expanded)

    def _run_batch(self, bucket: Bucket, entries) -> None:
        # batch phases are timed once and attributed to every query in the
        # batch as spans on its TraceContext (DESIGN.md §12 span taxonomy);
        # so are the core's spans of the dispatch, recorded into ``core``
        t_batch0 = time.perf_counter()
        blabel = _bucket_label(bucket)
        phases: list[tuple[str, float, float, dict]] = []
        traced = any(e.request.trace is not None for e in entries)
        core = TraceContext("device_dispatch") if traced else None
        try:
            snap = self._snap  # one snapshot for the whole batch
            t0 = time.perf_counter()
            args = self._assemble(bucket, entries, _index_device(snap.index))
            phases.append(("batch_assembly", t0, time.perf_counter(),
                           {"bucket": blabel, "requests": len(entries)}))
            with tracing(core):
                if isinstance(snap.index, SegmentPool):
                    ids, scores, ps, expanded = self._run_pool(snap.index, bucket, args, phases)
                elif isinstance(snap.index, SegmentedIndex):
                    t0 = time.perf_counter()
                    hit = self._lookup(group_shape_key(snap.index), bucket)
                    t1 = time.perf_counter()
                    phases.append(("executable_lookup", t0, t1, {"hit": hit}))
                    self._m_group_dispatch.inc(group=0)
                    res = self._run_group(snap.index, args)
                    ids, scores = _host(res.ids), _host(res.scores)
                    ps, expanded = _host(res.path_scores), _host(res.expanded)
                    phases.append(("device_dispatch", t1, time.perf_counter(), {}))
                else:
                    t0 = time.perf_counter()
                    hit = self._lookup(self._index_key(snap.index), bucket)
                    t1 = time.perf_counter()
                    phases.append(("executable_lookup", t0, t1, {"hit": hit}))
                    res = search_padded(snap.index, *args, self.params)
                    ids, scores = _host(res.ids), _host(res.scores)
                    ps, expanded = _host(res.path_scores), _host(res.expanded)
                    phases.append(("device_dispatch", t1, time.perf_counter(), {}))
            if snap.grow is not None:
                ids, scores, ps, expanded = self._merge_grow(
                    snap, args, ids, scores, ps, expanded, phases)
        except Exception as err:
            # entries are already dequeued: fail every waiter so no result()
            # blocks forever, then surface to the driving thread
            for e in entries:
                e.pending._fail(err)
            raise
        for i, e in enumerate(entries):
            e.pending._fulfill(ids[i, : e.request.k], scores[i, : e.request.k],
                               int(expanded[i]), path_scores=ps[i, : e.request.k])
        t_done = time.perf_counter()
        for e in entries:
            self._m_queue_wait.observe(t_batch0 - e.arrival_perf)
            self._m_latency.observe(t_done - e.arrival_perf)
            ctx = e.request.trace
            if ctx is not None:
                ctx.add_span("queue_wait", e.arrival_perf, t_batch0, bucket=blabel)
                for name, p0, p1, attrs in phases:
                    span = ctx.add_span(name, p0, p1, **attrs)
                    if name == "device_dispatch":
                        ctx.graft(span, core)
        self._m_batch_exec.observe(t_done - t_batch0, bucket=blabel)
        self.stats._batches.inc(bucket=blabel)
        self.stats._padded_slots.inc(bucket.batch - len(entries))

    def _assemble(self, bucket: Bucket, entries, device):
        """Pack requests into the bucket's fixed shapes on the index's
        device. Pad rows carry the all-zero fusion spec and PAD ids; their
        results are discarded. Every spec is resolved against the running
        stats, so fusion stays data, never part of the cache key."""
        m = len(entries)
        b = bucket.batch
        padn = b - m

        def stack(get, fill):
            rows = [torch.as_tensor(get(e.request.query)) for e in entries]
            t = torch.stack(rows).to(device)
            if padn:
                t = torch.cat([t, torch.full((padn,) + tuple(t.shape[1:]), fill,
                                             dtype=t.dtype, device=device)])
            return t

        queries = FusedVectors(
            stack(lambda q: q.dense, 0).to(torch.float32),
            SparseVec(stack(lambda q: q.learned.idx, PAD_IDX).to(torch.int32),
                      stack(lambda q: q.learned.val, 0).to(torch.float32)),
            SparseVec(stack(lambda q: q.lexical.idx, PAD_IDX).to(torch.int32),
                      stack(lambda q: q.lexical.val, 0).to(torch.float32)),
        )
        pad_spec = self._resolve_spec(FusionSpec.zero())
        fusion = stack_specs([self._resolve_spec(e.request.fusion) for e in entries]
                             + [pad_spec] * padn)
        kw = np.full((b, bucket.kw_width), PAD_IDX, np.int32)
        en = np.full((b, bucket.ent_width), PAD_IDX, np.int32)
        for i, e in enumerate(entries):
            if e.request.keywords is not None and len(e.request.keywords):
                kws = np.asarray(e.request.keywords, np.int32)
                kw[i, : len(kws)] = kws
            if e.request.entities is not None and len(e.request.entities):
                ens = np.asarray(e.request.entities, np.int32)
                en[i, : len(ens)] = ens
        return (queries, fusion, torch.as_tensor(kw, device=device),
                torch.as_tensor(en, device=device))

    # -- synchronous convenience -------------------------------------------

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
        """Submit a whole batch row by row and flush; results come back as
        one SearchResult of host (CPU) tensors. ``fusion`` is one spec, a
        batched (B,)-leaf spec or a per-row sequence; ``weights=`` is the
        deprecated ``PathWeights`` spelling. 2-D keyword/entity arrays may be
        PAD_IDX padded; pad slots are stripped per row."""

        def row_ids(arr, i):
            if arr is None:
                return None
            row = np.asarray(arr)[i]
            row = row[row >= 0]
            return row if len(row) else None

        if fusion is not None and weights is not None:
            raise ValueError("pass fusion= or (deprecated) weights=, not both")
        if fusion is None:
            if weights is None:
                raise TypeError("search() requires fusion=FusionSpec(...)")
            fusion = weights  # deprecated form; as_fusion_spec warns below
        b = queries.n
        k = self.params.k if k is None else k
        if isinstance(fusion, (FusionSpec, PathWeights)):
            spec = as_fusion_spec(fusion)
            if np.ndim(spec.mode) >= 1:  # batched (B,)-leaf form
                get_f = lambda i: _spec_row(spec, i)
            else:
                get_f = lambda i: spec
        else:  # per-row sequence of FusionSpec / deprecated PathWeights
            rows = [as_fusion_spec(f) for f in fusion]
            get_f = lambda i: rows[i]
        reqs = [
            SearchRequest(query=queries[i], fusion=get_f(i), k=k,
                          keywords=row_ids(keywords, i), entities=row_ids(entities, i),
                          trace=trace)
            for i in range(b)
        ]
        # validate the whole batch before enqueuing anything
        for req in reqs:
            self._validate(req)
        pendings = []
        for req in reqs:
            try:
                pendings.append(self.submit(req))
            except QueueFullError:
                self.flush()  # drain to make room rather than strand queued rows
                pendings.append(self.submit(req))
        try:
            self.flush()
        except Exception:  # noqa: BLE001 - per-row errors surface from result()
            pass
        ids = np.stack([p.result()[0] for p in pendings])
        scores = np.stack([p.result()[1] for p in pendings])
        ps = np.stack([p.path_scores for p in pendings])
        return SearchResult(
            ids=torch.as_tensor(ids),
            scores=torch.as_tensor(scores),
            expanded=torch.as_tensor([p.expanded for p in pendings], dtype=torch.int32),
            path_scores=torch.as_tensor(ps),
        )
