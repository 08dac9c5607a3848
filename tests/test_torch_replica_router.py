"""The port's replica tier (``repro_torch.serving.replica_router``) against
repro's. Placement: ``build_ring`` / ``ring_homes`` give repro's owners for
any names and ids, and removing a replica remaps only its ids. Reads: the
scatter-gather contract (DESIGN.md §9) — a tier over any replica partition
returns what one service over every surviving doc returns, up to
equal-score ties, with streamed inserts, deletes, compaction and KG entity
paths mixed in — held against the port's own single service, and the
port's tier against repro's tier on the same repro-built pools. Then the
router's mechanics: degraded reads (``down_replicas`` as repro's),
``fail_on_partial``, the mirror tier's least-outstanding dispatch,
pinned-id validation, the ``allanpoe_replica_*`` series, and text streamed
in through ``IngestPipeline.stream_into``.

repro's own case ``[2-64-32-deletes1-True-70]`` is red (ROADMAP Queue 3):
its single service, at 48 expansions, does not saturate. The port's tier is
held to the contract there with search parameters that do."""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small tensors: threads only contend with the other workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from repro.core import segment_pool as rpool  # noqa: E402
from repro.core.fusion import FusionSpec as RFusionSpec  # noqa: E402
from repro.core.index import BuildConfig as RBuildConfig  # noqa: E402
from repro.core.knn_graph import KnnConfig as RKnnConfig  # noqa: E402
from repro.core.pruning import PruneConfig as RPruneConfig  # noqa: E402
from repro.core.search import SearchParams as RSearchParams  # noqa: E402
from repro.data.corpus import CorpusConfig, make_corpus  # noqa: E402
from repro.serving import batcher as rbatcher  # noqa: E402
from repro.serving import hybrid_service as rsvc  # noqa: E402
from repro.serving import replica_router as rrr  # noqa: E402
from repro.serving import segment_router as rrouter  # noqa: E402
from repro_torch.convert import pool_from_arrays  # noqa: E402
from repro_torch.core.build_pipeline import build_index  # noqa: E402
from repro_torch.core.fusion import FusionSpec  # noqa: E402
from repro_torch.core.index import BuildConfig  # noqa: E402
from repro_torch.core.knn_graph import KnnConfig  # noqa: E402
from repro_torch.core.pruning import PruneConfig  # noqa: E402
from repro_torch.core.search import SearchParams, search  # noqa: E402
from repro_torch.core.segment_pool import SegmentPool, append_segment, build_pool_segment  # noqa: E402
from repro_torch.data.syncorpus import SynCorpus, SynCorpusConfig  # noqa: E402
from repro_torch.ingest import IngestConfig, IngestPipeline  # noqa: E402
from repro_torch.obs.tracer import TraceContext  # noqa: E402
from repro_torch.serving import replica_router as trr  # noqa: E402
from repro_torch.serving.batcher import BatcherConfig, _next_pow2  # noqa: E402
from repro_torch.serving.hybrid_service import HybridSearchService, ServiceConfig  # noqa: E402
from repro_torch.serving.segment_router import RouterConfig, SegmentRouter  # noqa: E402
from tests.test_torch_build import to_torch  # noqa: E402

KNN = dict(k=8, iters=2, node_chunk=128)
PRUNE = dict(degree=8, keyword_degree=3, node_chunk=64)
R_CFG = RBuildConfig(knn=RKnnConfig(use_kernel=False, **KNN),
                     prune=RPruneConfig(use_kernel=False, **PRUNE), path_refine_iters=0)
T_CFG = BuildConfig(knn=KnnConfig(**KNN), prune=PruneConfig(**PRUNE), path_refine_iters=0)
# the contract's builds: twice the degree, so every doc of these layouts is
# reachable from its graph's entry points (at degree 8 the monolithic graph
# of the deletes1 layout never reaches doc 47, ROADMAP Queue 3)
DENSE = dict(knn=dict(k=16, iters=2, node_chunk=128),
             prune=dict(degree=16, keyword_degree=4, node_chunk=64))
R_DENSE = RBuildConfig(knn=RKnnConfig(use_kernel=False, **DENSE["knn"]),
                       prune=RPruneConfig(use_kernel=False, **DENSE["prune"]), path_refine_iters=0)
T_DENSE = BuildConfig(knn=KnnConfig(**DENSE["knn"]), prune=PruneConfig(**DENSE["prune"]),
                      path_refine_iters=0)
# saturating search: the pool covers the whole tiny corpus and a search
# expands at least as many nodes as there are docs, so any layout whose
# docs are all reachable degenerates to (the same) exact scoring. (repro's
# test takes iters=48: in its deletes1 layout the monolithic graph's doc 64,
# with one in-edge, is reached only after 48 expansions, ROADMAP Queue 3.)
PARAMS = dict(k=10, iters=128, pool_size=128, use_kg=True)
VNODES = 16
N_TOTAL, N_QUERIES = 96, 6
BATCH = dict(flush_size=N_QUERIES, max_batch=8, flush_deadline_s=60.0)
ROUTER = dict(seal_threshold=10**9, compaction="incremental", tier_fanout=2, auto_merge=False)


@pytest.fixture(scope="module")
def corpus():
    return make_corpus(CorpusConfig(n_docs=N_TOTAL, n_queries=N_QUERIES, n_topics=8,
                                    d_dense=16, nnz_sparse=8, nnz_lexical=6, seed=43))


_POOLS: dict = {}


def repro_pools(corpus, n0: int, n_replicas: int, cfg=R_CFG) -> list:
    """repro-built pools sharding docs [0, n0) by the ring the tier routes
    with, one sealed segment per replica (cached per layout)."""
    if (n0, n_replicas, cfg) not in _POOLS:
        names = [f"replica{i}" for i in range(n_replicas)]
        homes = rrr.ring_homes(rrr.build_ring(names, VNODES), np.arange(n0))
        pools = []
        for i in range(n_replicas):
            rows = np.flatnonzero(homes == i)
            assert rows.size, "an empty shard: reseed the test"
            seg = rpool.build_pool_segment(
                jax.tree.map(lambda a: jnp.asarray(a[rows]), corpus.docs), rows, cfg,
                capacity=_next_pow2(int(rows.size)), key=jax.random.key(5 + i),
                kg_triplets=corpus.kg.triplets, doc_entities=corpus.doc_entities[rows],
                n_entities=corpus.kg.n_entities)
            pools.append(rpool.SegmentPool.from_segmented(seg))
        _POOLS[(n0, n_replicas, cfg)] = pools
    return _POOLS[(n0, n_replicas, cfg)]


def port_tier(corpus, n0: int, n_replicas: int, dense: bool = False, **tier_kw):
    """The port's tier over repro-built pools (``dense``: the contract's
    builds), a SegmentRouter on every replica."""
    reps = []
    for i, pool in enumerate(repro_pools(corpus, n0, n_replicas, R_DENSE if dense else R_CFG)):
        svc = HybridSearchService(pool_from_arrays(pool, "cpu"), SearchParams(**PARAMS),
                                  ServiceConfig(batcher=BatcherConfig(**BATCH)))
        router = SegmentRouter(svc, T_DENSE if dense else T_CFG, RouterConfig(**ROUTER),
                               kg_triplets=corpus.kg.triplets, n_entities=corpus.kg.n_entities)
        reps.append(trr.Replica(svc, router, name=f"replica{i}"))
    return trr.ReplicaRouter(reps, trr.ReplicaTierConfig(virtual_nodes=VNODES, **tier_kw))


def repro_tier(corpus, n0: int, n_replicas: int, **tier_kw):
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("data",))
    reps = []
    for i, pool in enumerate(repro_pools(corpus, n0, n_replicas)):
        svc = rsvc.HybridSearchService(
            rpool.place_pool(pool, mesh), RSearchParams(use_kernel=False, **PARAMS),
            rsvc.ServiceConfig(batcher=rbatcher.BatcherConfig(**BATCH)), mesh=mesh)
        router = rrouter.SegmentRouter(svc, R_CFG, rrouter.RouterConfig(**ROUTER),
                                       kg_triplets=corpus.kg.triplets,
                                       n_entities=corpus.kg.n_entities)
        reps.append(rrr.Replica(svc, router, name=f"replica{i}"))
    return rrr.ReplicaRouter(reps, rrr.ReplicaTierConfig(virtual_nodes=VNODES, **tier_kw))


def canonical(ids, scores):
    """Rows as score-descending groups of id sets: equal-score ties compare
    as sets, so layouts that order ties differently still compare equal."""
    rows = []
    for row_ids, row_sc in zip(np.asarray(ids), np.asarray(scores)):
        valid = row_ids >= 0
        groups: dict = {}
        for i, s in zip(row_ids[valid], np.round(row_sc[valid], 4)):
            groups.setdefault(float(s), set()).add(int(i))
        rows.append(sorted(groups.items(), reverse=True))
    return rows


def queries(corpus):
    return to_torch(corpus.queries)


# -- placement ----------------------------------------------------------------


@pytest.mark.parametrize("vnodes", [1, 16, 512])
@pytest.mark.parametrize("names", [("replica0", "replica1", "replica2", "replica3"),
                                   ("a", "bb", "z#9", "é")])
def test_ring_and_homes_equal_repro(names, vnodes):
    assert trr.build_ring(names, vnodes) == rrr.build_ring(names, vnodes)
    ring = trr.build_ring(names, vnodes)
    ids = np.concatenate([np.arange(3000), np.random.default_rng(vnodes).integers(
        0, 2**31 - 1, 2000)])
    np.testing.assert_array_equal(trr.ring_homes(ring, ids), rrr.ring_homes(ring, ids))
    with pytest.raises(RuntimeError, match="no replica is up"):
        trr.ring_homes([], ids)


def test_placement_stable_and_minimal(corpus):
    """Placement is a pure function of (names, id); removing a replica
    remaps only the ids homed on it, and restoring it restores them."""
    ids = np.arange(500)
    h = trr.ring_homes(trr.build_ring(["replica0", "replica1", "replica2"], 64), ids)
    assert (np.bincount(h, minlength=3) > 50).all()
    tier = port_tier(corpus, 48, 3)
    try:
        before = tier.homes_of(ids)
        tier.mark_down(1)
        after = tier.homes_of(ids)
        moved = before != after
        assert moved.any() and (before[moved] == 1).all()
        assert not (after == 1).any()
        tier.mark_up(1)
        np.testing.assert_array_equal(tier.homes_of(ids), before)
        assert tier.replica_for(7) == int(before[7])
    finally:
        tier.close()


# -- the scatter-gather contract -------------------------------------------


@pytest.mark.parametrize(
    "n_replicas,n0,n_insert,deletes,compact,probe",
    [
        (2, 48, 16, [], False, 10),  # plain sharded read after a tier insert
        (2, 64, 32, [3, 50, 90], True, 70),  # deletes over sealed and inserted, compaction
        (3, 48, 32, [0, 47, 48, 79], True, 60),  # three replicas, shard-boundary deletes
        (1, 48, 16, [5], False, 20),  # a lone replica: the identity merge
    ],
)
def test_scatter_gather_equals_single_service(corpus, n_replicas, n0, n_insert, deletes,
                                              compact, probe):
    total = n0 + n_insert
    tier = port_tier(corpus, n0, n_replicas, dense=True)
    try:
        gids = tier.insert(to_torch(corpus.docs[n0:total]),
                           new_doc_entities=corpus.doc_entities[n0:total])
        assert gids.tolist() == list(range(n0, total))
        homes = tier.homes_of(gids)
        for i, r in enumerate(tier.replicas):  # each doc on its home's grow segment
            grow = r.service._snap.grow_gids
            held = [] if grow is None else grow.tolist()
            assert held == gids[homes == i].tolist()
        if compact:
            tier.replicas[0].router.compact_incremental()
        if deletes:
            assert tier.delete(deletes) == len(deletes)
        live = np.asarray([g for g in range(total) if g not in deletes])
        ref_idx = build_index(to_torch(corpus.docs[live]), T_DENSE, device="cpu",
                              kg_triplets=corpus.kg.triplets,
                              doc_entities=corpus.doc_entities[live],
                              n_entities=corpus.kg.n_entities)
        got = tier.search(queries(corpus), FusionSpec.three_path(), k=10)
        ref = search(ref_idx, queries(corpus), FusionSpec.three_path(), SearchParams(**PARAMS),
                     device="cpu")
        loc = ref.ids.numpy()
        ref_ids = np.where(loc >= 0, live[np.clip(loc, 0, live.size - 1)], -1)
        assert canonical(got.ids, got.scores) == canonical(ref_ids, ref.scores)
        assert got.down_replicas is None
        assert not set(deletes) & set(got.ids.numpy().ravel().tolist())
        # KG reachability through the tier: a surviving doc's unique rare
        # entity (entity id == doc id in make_corpus) reaches it across
        # whichever replica holds it
        res = tier.search(queries(corpus)[0:1], FusionSpec.weighted(0.2, 0.2, 0.2, kg=2.0),
                          entities=np.asarray([[probe]], np.int32), k=10)
        assert probe in res.ids.numpy()[0]
    finally:
        tier.close()


@pytest.mark.parametrize("n_replicas", [2, 3])
@pytest.mark.parametrize("mode", ["three_path", "rrf", "zscore", "batched"])
def test_tier_equals_repro_tier(corpus, n_replicas, mode):
    """The port's tier against repro's on the same repro-built pools:
    the same ids up to ties, scores to 1e-4, the same dispatch counts."""
    t, r = port_tier(corpus, 64, n_replicas), repro_tier(corpus, 64, n_replicas)
    try:
        if mode == "batched":
            t_spec = [FusionSpec.three_path(), FusionSpec.rrf(), FusionSpec.zscore(),
                      FusionSpec.weighted(1, 0, 0), FusionSpec.minmax(), FusionSpec.rrf()]
            r_spec = [RFusionSpec.three_path(), RFusionSpec.rrf(), RFusionSpec.zscore(),
                      RFusionSpec.weighted(1, 0, 0), RFusionSpec.minmax(), RFusionSpec.rrf()]
        else:
            t_spec, r_spec = getattr(FusionSpec, mode)(), getattr(RFusionSpec, mode)()
        got = t.search(queries(corpus), t_spec, k=10)
        want = r.search(jax.tree.map(jnp.asarray, corpus.queries), r_spec, k=10)
        # the same top-10 sets; scores to 1e-4 relative (z-scored scores
        # reach 1e5 here, where the stats' float order shows in the 8th digit)
        for gi, wi in zip(got.ids.numpy(), np.asarray(want.ids)):
            assert set(gi.tolist()) == set(wi.tolist())
        np.testing.assert_allclose(np.sort(got.scores.numpy(), 1),
                                   np.sort(np.asarray(want.scores), 1), rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(got.expanded.numpy(), np.asarray(want.expanded))
        assert t.stats.dispatched == r.stats.dispatched
    finally:
        t.close()
        r.close()


# -- mechanics ------------------------------------------------------------------


def test_degraded_reads_match_repro(corpus):
    t, r = port_tier(corpus, 48, 2), repro_tier(corpus, 48, 2)
    try:
        shard = set(np.flatnonzero(
            trr.ring_homes(trr.build_ring(["replica0", "replica1"], VNODES), np.arange(48))
            == 1).tolist())
        healthy = t.search(queries(corpus), FusionSpec.three_path(), k=10)
        t.mark_down(1)
        r.mark_down(1)
        ctx = TraceContext("read")
        res = t.search(queries(corpus), FusionSpec.three_path(), k=10, trace=ctx)
        want = r.search(jax.tree.map(jnp.asarray, corpus.queries), RFusionSpec.three_path(),
                        k=10)
        assert res.down_replicas == want.down_replicas == ("replica1",)
        assert ctx.root.attrs.get("down_replicas") == ["replica1"]
        assert {s.name for s in ctx.root.walk()} >= {"scatter_gather", "replica_dispatch",
                                                     "fusion_rescore"}
        assert t.stats.partial_searches == 1 and t.stats.degraded_reads("replica1") == 1
        assert t.stats.degraded_reads("replica0") == 0
        got = set(res.ids.numpy().ravel().tolist())
        assert not got & shard and got - {-1}
        assert canonical(res.ids, res.scores) == canonical(want.ids, want.scores)
        t.mark_up(1)
        again = t.search(queries(corpus), FusionSpec.three_path(), k=10)
        assert torch.equal(again.ids, healthy.ids) and torch.equal(again.scores, healthy.scores)
        assert again.down_replicas is None
    finally:
        t.close()
        r.close()


def test_fail_on_partial_raises_after_recording(corpus):
    tier = port_tier(corpus, 48, 2, fail_on_partial=True)
    try:
        tier.mark_down(0)
        ctx = TraceContext("read")
        with pytest.raises(RuntimeError, match="replicas down"):
            tier.search(queries(corpus), FusionSpec.three_path(), k=10, trace=ctx)
        assert tier.stats.degraded_reads("replica0") == 1
        assert ctx.root.attrs.get("down_replicas") == ["replica0"]
        tier.mark_down(1)
        with pytest.raises(RuntimeError, match="no replica is up"):
            tier.search(queries(corpus), FusionSpec.three_path(), k=10)
    finally:
        tier.close()


def test_mirror_tier_least_outstanding_dispatch(corpus):
    """Mirror placement: full copies, each batch to exactly ONE replica —
    the least loaded; writes broadcast to every up replica."""
    reps = []
    for i in range(2):
        seg = build_pool_segment(to_torch(corpus.docs[:48]), np.arange(48), T_CFG, capacity=64,
                                 generator=torch.Generator().manual_seed(9), device="cpu",
                                 kg_triplets=corpus.kg.triplets,
                                 doc_entities=corpus.doc_entities[:48],
                                 n_entities=corpus.kg.n_entities)
        svc = HybridSearchService(SegmentPool.from_segmented(seg), SearchParams(**PARAMS),
                                  ServiceConfig(batcher=BatcherConfig(**BATCH)))
        router = SegmentRouter(svc, T_CFG, RouterConfig(**ROUTER),
                               kg_triplets=corpus.kg.triplets, n_entities=corpus.kg.n_entities)
        reps.append(trr.Replica(svc, router, name=f"replica{i}"))
    tier = trr.ReplicaRouter(reps, trr.ReplicaTierConfig(placement="mirror",
                                                         virtual_nodes=VNODES))
    try:
        r1 = tier.search(queries(corpus), FusionSpec.three_path(), k=10)
        assert tier.stats.dispatched == [1, 0]
        tier.replicas[0].outstanding = 5  # replica0 busy: dispatch must pick replica1
        r2 = tier.search(queries(corpus), FusionSpec.three_path(), k=10)
        assert tier.stats.dispatched == [1, 1]
        assert canonical(r1.ids, r1.scores) == canonical(r2.ids, r2.scores)
        gids = tier.insert(to_torch(corpus.docs[48:52]),
                           new_doc_entities=corpus.doc_entities[48:52])
        assert gids.tolist() == [48, 49, 50, 51]
        for r in tier.replicas:
            assert r.service._snap.grow_gids.tolist() == [48, 49, 50, 51]
        tier.delete([49])
        for r in tier.replicas:
            assert r.router.live_grow_size == 3
    finally:
        tier.close()


def test_pinned_global_ids_validation(corpus):
    tier = port_tier(corpus, 48, 2)
    try:
        router = tier.replicas[0].router
        docs = to_torch(corpus.docs[48:52])
        ents = corpus.doc_entities[48:52]
        with pytest.raises(ValueError, match="strictly increasing"):
            router.insert(docs, global_ids=np.asarray([60, 59, 61, 62]), new_doc_entities=ents)
        with pytest.raises(ValueError, match="strictly increasing"):
            router.insert(docs, global_ids=np.asarray([0, 1, 2, 3]), new_doc_entities=ents)
        with pytest.raises(ValueError, match="map every new doc"):
            router.insert(docs, global_ids=np.asarray([100, 101]), new_doc_entities=ents)
        with pytest.raises(ValueError, match="unique"):
            trr.ReplicaRouter([tier.replicas[0], tier.replicas[0]])
        with pytest.raises(ValueError, match="placement"):
            trr.ReplicaTierConfig(placement="ring")
    finally:
        tier.close()


def test_replica_series_equal_repro(corpus):
    t, r = port_tier(corpus, 48, 2), repro_tier(corpus, 48, 2)
    try:
        for tier, q, spec in ((t, queries(corpus), FusionSpec.three_path()),
                              (r, jax.tree.map(jnp.asarray, corpus.queries),
                               RFusionSpec.three_path())):
            tier.mark_down(1)
            tier.search(q, spec, k=10)
            tier.mark_up(1)
            tier.search(q, spec, k=10)
            tier.delete([3])
        series = lambda tier: sorted((m.name, tuple(m.label_names),
                                      tuple(sorted(m.values().items())))
                                     for m in tier.metrics.metrics())
        assert series(t) == series(r)
        assert all(name.startswith("allanpoe_replica_") for name, _, _ in series(t))
        assert repr(t.stats).replace("ReplicaTierStats", "") == \
            repr(r.stats).replace("ReplicaTierStats", "")
        assert t.shard_sizes() == r.shard_sizes()
    finally:
        t.close()
        r.close()


def test_text_streamed_into_a_tier():
    """SynCorpus text through a fitted pipeline into a two-replica tier:
    the ids come back contiguous, each doc lands on its home's grow
    segment, finds itself by its own text, and a deleted id is gone."""
    gen = SynCorpus(SynCorpusConfig(n_docs=224, n_topics=8, n_entities=24, seed=1))
    pipe = IngestPipeline(IngestConfig(d_dense=32), device="cpu")
    fit = pipe.fit(gen.fit_sample(128))
    kg = dict(kg_triplets=fit.kg.triplets, n_entities=fit.kg.n_entities)
    docs, ents = pipe.encode_docs(gen.texts(0, 192))
    homes = trr.ring_homes(trr.build_ring(["replica0", "replica1"], VNODES), np.arange(192))
    reps = []
    for i in range(2):
        pool = SegmentPool(groups=[])
        rows = np.flatnonzero(homes == i)
        for s in range(0, rows.size, 64):  # sealed every 64 rows, as the scale run does
            part = rows[s:s + 64]
            seg = build_pool_segment(docs.take(torch.as_tensor(part)), part, T_CFG,
                                     capacity=_next_pow2(part.size), device="cpu",
                                     doc_entities=ents[part], **kg)
            pool, _ = append_segment(pool, seg)
        svc = HybridSearchService(pool, SearchParams(k=10, iters=48, pool_size=128),
                                  ServiceConfig(batcher=BatcherConfig(**BATCH)))
        reps.append(trr.Replica(svc, SegmentRouter(svc, T_CFG, RouterConfig(**ROUTER), **kg),
                                name=f"replica{i}"))
    tier = trr.ReplicaRouter(reps, trr.ReplicaTierConfig(virtual_nodes=VNODES))
    try:
        texts = gen.texts(192, 224)
        gids = pipe.stream_into(tier, texts)
        assert gids.tolist() == list(range(192, 224))
        new_homes = tier.homes_of(gids)
        for i, r in enumerate(tier.replicas):
            assert r.service._snap.grow_gids.tolist() == gids[new_homes == i].tolist()
        enc = pipe.encode_queries(texts[:6])
        got = tier.search(enc.vectors, FusionSpec.three_path(), k=10).ids.numpy()
        assert all(g in row for g, row in zip(gids[:6], got))
        tier.delete(gids[:3])
        got = tier.search(enc.vectors, FusionSpec.three_path(), k=10).ids.numpy()
        assert not set(gids[:3].tolist()) & set(got.ravel().tolist())
        stats = tier.path_stats()
        assert tuple(stats.mean.shape) == (3,)
    finally:
        tier.close()
