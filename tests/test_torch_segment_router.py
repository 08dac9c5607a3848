"""The port's segment router (``repro_torch.serving.segment_router``) against
repro's. One repro-built pool, converted with ``convert.py``, is served by
both packages' ``HybridSearchService`` with a router attached; the port's
router takes repro's draws (rebuilt from repro's keys, ``fold_in(key(salt),
version)``) through its ``_randomness`` hook. After every insert, delete,
compaction (incremental and full) and merge the two hold the same pool
layout, global ids, alive masks and grow map exactly, graph edges as row
sets in >= 99% of rows, and the same search results up to ties. Then the
router's own behaviour, as tests/test_segment_router.py and
tests/test_segment_pool.py hold repro's: background merges equal
synchronous ones, ``build_rows`` counts the live grow rows at compaction,
auto-compaction at the threshold, O(log growth) grow shapes, pinned ids,
re-attachment, the KG, auto-checkpoints and the pump during inserts."""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small tensors: threads only contend with the other workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import segment_pool as rpool  # noqa: E402
from repro.core.fusion import FusionSpec as RFusionSpec  # noqa: E402
from repro.core.search import SearchParams as RSearchParams  # noqa: E402
from repro.data.corpus import CorpusConfig, make_corpus  # noqa: E402
from repro.serving import batcher as rbatcher  # noqa: E402
from repro.serving import hybrid_service as rsvc  # noqa: E402
from repro.serving import segment_router as rrouter  # noqa: E402
from repro_torch.convert import pool_from_arrays  # noqa: E402
from repro_torch.core.fusion import FusionSpec  # noqa: E402
from repro_torch.core.search import SearchParams  # noqa: E402
from repro_torch.core.segment_pool import live_counts, resolve_global_ids_pool  # noqa: E402
from repro_torch.core.usms import QuantizedFusedVectors  # noqa: E402
from repro_torch.runtime import dispatch  # noqa: E402
from repro_torch.serving.batcher import BatcherConfig, SearchRequest  # noqa: E402
from repro_torch.serving.hybrid_service import HybridSearchService, ServiceConfig  # noqa: E402
from repro_torch.serving.segment_router import (  # noqa: E402
    FULL_SALT,
    RouterConfig,
    SegmentRouter,
)
from tests.test_torch_build import rows_equal_as_sets, to_torch  # noqa: E402
from tests.test_torch_insert import R_CFG, T_CFG, descent_draws, host  # noqa: E402

N_SEALED = 256
PARAMS = dict(k=8, iters=16, pool_size=48)
TOL = 1e-4
NO_COMPACT = dict(seal_threshold=10**9)


@pytest.fixture(scope="module")
def corpus():
    return make_corpus(CorpusConfig(n_docs=448, n_queries=16, n_topics=8, d_dense=16,
                                    nnz_sparse=8, nnz_lexical=6, seed=23))


@pytest.fixture(scope="module")
def sealed(corpus):
    """repro's one-segment pool over the first N_SEALED docs."""
    docs = jax.tree.map(jnp.asarray, corpus.docs[:N_SEALED])
    seg = rpool.build_pool_segment(docs, np.arange(N_SEALED), R_CFG, key=jax.random.key(1))
    return rpool.SegmentPool.from_segmented(seg)


def repro_source(salt: int, version: int, n: int):
    """repro's draws for a router write: key(salt) folded with the snapshot
    version (a full rebuild builds its one segment from fold_in(key, 0))."""
    key = jax.random.fold_in(jax.random.key(salt), version)
    if salt == FULL_SALT:
        key = jax.random.fold_in(key, 0)
    return descent_draws(n, R_CFG.knn, key)


def repro_router(*args, **kw) -> SegmentRouter:
    """A port router whose writes take repro's draws in place of its own."""
    router = SegmentRouter(*args, **kw)
    own = router._randomness

    def randomness(salt, n, generator, draws):
        version = router.service._snap.version
        generator, draws = own(salt, n, generator, draws)
        return generator, repro_source(salt, version, n) if draws is None else draws

    router._randomness = randomness
    return router


def pair(sealed, dtype="float32", **router):
    """(port service, port router, repro service, repro router) over the
    same pool, with the same configs."""
    batch = dict(flush_size=4, max_batch=4)
    r_pool = sealed
    if dtype == "int8":
        r_pool = rpool.SegmentPool(groups=[dataclasses.replace(g, index=dataclasses.replace(
            g.index, corpus=jax.vmap(rpool.quantize_corpus)(g.index.corpus)))
            for g in sealed.groups])
    r = rsvc.HybridSearchService(
        r_pool, RSearchParams(use_kernel=False, corpus_dtype=dtype, **PARAMS),
        rsvc.ServiceConfig(batcher=rbatcher.BatcherConfig(**batch)))
    rr = rrouter.SegmentRouter(r, R_CFG, rrouter.RouterConfig(**router))
    t = HybridSearchService(pool_from_arrays(r_pool, "cpu"),
                            SearchParams(corpus_dtype=dtype, **PARAMS),
                            ServiceConfig(batcher=BatcherConfig(**batch)))
    tr = repro_router(t, T_CFG, RouterConfig(**router))
    return t, tr, r, rr


def three_path():
    return FusionSpec.three_path()


def assert_search_close(t_svc, r_svc, corpus, probes):
    """Both services over one batch: four queries under three-path weights
    and the probe docs' own vectors under dense-only weights (per-row
    fusion; four probes keep every batch in one bucket). The same ids up
    to ties, scores to TOL; the probes' first ids equal (returned)."""
    dense = dict(zip(("dense", "sparse", "full"), (1.0, 0.0, 0.0)))
    qs = corpus.queries

    def widen(a, like, fill):  # doc ELL rows padded to the queries' widths
        a = np.asarray(a)
        out = np.full(np.shape(like)[1:], fill, a.dtype)
        out[: a.shape[0]] = a
        return out

    q = [jax.tree.map(lambda a: np.asarray(a)[i], qs) for i in range(4)] + [
        type(qs)(np.asarray(corpus.docs.dense)[d],
                 *(type(getattr(qs, p))(widen(getattr(corpus.docs, p).idx[d],
                                              getattr(qs, p).idx, -1),
                                        widen(getattr(corpus.docs, p).val[d],
                                              getattr(qs, p).val, 0))
                   for p in ("learned", "lexical"))) for d in probes]
    cat = lambda parts: jax.tree.map(lambda *xs: np.stack(xs), *parts)
    t_specs = [three_path()] * 4 + [FusionSpec.make("weighted_sum", **dense)] * len(probes)
    r_specs = [RFusionSpec.three_path()] * 4 + [RFusionSpec.make("weighted_sum", **dense)] * len(
        probes)
    got = t_svc.search(to_torch(cat(q)), t_specs, k=5)
    want = r_svc.search(jax.tree.map(jnp.asarray, cat(q)), r_specs, k=5)
    gi, wi = got.ids.numpy(), np.asarray(want.ids)
    gs, ws = got.scores.numpy(), np.asarray(want.scores)
    same = gi == wi
    assert same.mean() >= 0.95, f"ids diverged:\n{gi}\n{wi}"
    np.testing.assert_allclose(gs[same], ws[same], rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(gi[4:, 0], wi[4:, 0])
    return wi[4:, 0]


def assert_state_matches(t_svc, r_svc):
    tp, rp = t_svc.index, r_svc.index
    assert tp.capacities == rp.capacities and tp.segments() == rp.segments()
    for tg, rg in zip(tp.groups, rp.groups):
        np.testing.assert_array_equal(host(tg.global_ids), np.asarray(rg.global_ids))
        np.testing.assert_array_equal(host(tg.index.alive), np.asarray(rg.index.alive))
        assert type(tg.index.corpus).__name__ == type(rg.index.corpus).__name__
        for f in ("semantic_edges", "keyword_edges"):
            g, w = host(getattr(tg.index, f)), np.asarray(getattr(rg.index, f))
            assert rows_equal_as_sets(g.reshape(-1, g.shape[-1]),
                                      w.reshape(-1, w.shape[-1])) >= 0.99
    tg, rg = t_svc.grow_index, r_svc.grow_index
    assert (tg is None) == (rg is None)
    if tg is not None:
        assert tg.n == rg.n
        np.testing.assert_array_equal(host(t_svc._snap.grow_gids),
                                      np.asarray(r_svc._snap.grow_gids))
        np.testing.assert_array_equal(host(tg.alive), np.asarray(rg.alive))
        assert rows_equal_as_sets(host(tg.semantic_edges), np.asarray(rg.semantic_edges)) >= 0.99
    assert t_svc.snapshot_version == r_svc.snapshot_version


def insert_both(t, r, corpus, lo, hi):
    """The same docs into both services."""
    t.insert(to_torch(corpus.docs[lo:hi]))
    r.insert(jax.tree.map(lambda a: jnp.asarray(a[lo:hi]), corpus.docs))


def test_router_requires_pool_service(corpus, sealed):
    from repro_torch.convert import index_from_arrays

    single = HybridSearchService(index_from_arrays(
        jax.tree.map(lambda a: a[0], sealed.groups[0].index), "cpu"), SearchParams(**PARAMS))
    with pytest.raises(ValueError, match="SegmentPool"):
        SegmentRouter(single, T_CFG)
    t, _, _, _ = pair(sealed, **NO_COMPACT)
    assert SegmentRouter(t, T_CFG, ingest=object())._ingest is not None  # pairs checkpoints


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_insert_delete_compact_incremental_match_repro(corpus, sealed, dtype):
    t, tr, r, rr = pair(sealed, dtype, **NO_COMPACT)
    insert_both(t, r, corpus, N_SEALED, N_SEALED + 32)  # grow born
    assert_state_matches(t, r)
    insert_both(t, r, corpus, N_SEALED + 32, N_SEALED + 64)  # grow extended
    assert_state_matches(t, r)
    assert_search_close(t, r, corpus, [N_SEALED + 5, N_SEALED + 40, 7, 200])
    dead = [N_SEALED + 3, 11, 9999]  # grow, sealed, unknown
    t.mark_deleted(dead)
    r.mark_deleted(dead)
    assert (tr.stats.deleted_grow, tr.stats.deleted_sealed, tr.stats.unknown_deletes) == \
        (rr.stats.deleted_grow, rr.stats.deleted_sealed, rr.stats.unknown_deletes) == (1, 1, 1)
    assert_state_matches(t, r)
    rows0 = dispatch.build_rows()
    tr.compact_incremental()
    rr.compact_incremental()
    assert dispatch.build_rows() - rows0 == 63  # the live grow rows, not the corpus
    assert tr.stats.incremental_compactions == 1 and t.grow_index is None
    assert_state_matches(t, r)
    assert isinstance(t.index.groups[-1].index.corpus,
                      QuantizedFusedVectors) == (dtype == "int8")
    grp, _, _ = resolve_global_ids_pool(t.index, [N_SEALED + 3, N_SEALED + 4, 11])
    assert grp[0] == -1 and grp[1] >= 0 and grp[2] >= 0  # grow tombstone gone, sealed kept
    assert_search_close(t, r, corpus, [N_SEALED + 40, N_SEALED + 7, 7, 200])
    for doc in (11, N_SEALED + 3):  # tombstoned: never returned
        assert doc not in t.search(to_torch(corpus.docs[doc:doc + 1]), three_path(),
                                   k=5).ids.numpy()
        assert doc not in np.asarray(r.search(jax.tree.map(
            lambda a: jnp.asarray(a[doc:doc + 1]), corpus.docs), RFusionSpec.three_path(),
            k=5).ids)
    assert tr.compact_incremental() == t.snapshot_version  # no grow: no-op


def test_seal_and_compact_matches_repro(corpus, sealed):
    t, tr, r, rr = pair(sealed, **NO_COMPACT)
    insert_both(t, r, corpus, N_SEALED, N_SEALED + 24)
    t.mark_deleted([3, N_SEALED + 1])
    r.mark_deleted([3, N_SEALED + 1])
    rows0 = dispatch.build_rows()
    tr.seal_and_compact()
    rr.seal_and_compact()
    assert dispatch.build_rows() - rows0 == N_SEALED + 24 - 2  # every survivor rebuilt
    assert tr.stats.compactions == 1 and t.index.n_groups == 1
    assert_state_matches(t, r)
    assert_search_close(t, r, corpus, [N_SEALED + 5, N_SEALED + 20, 100, 200])
    assert tr.seal_and_compact() == t.snapshot_version  # nothing to reclaim


def test_merges_and_size_tier_match_repro(corpus, sealed):
    cfg = dict(**NO_COMPACT, tier_fanout=2, background_merge=False)
    t, tr, r, rr = pair(sealed, **cfg)
    for b in range(4):
        lo = N_SEALED + 16 * b
        insert_both(t, r, corpus, lo, lo + 16)
        tr.compact_incremental()
        rr.compact_incremental()
        assert tr.stats.merges == rr.stats.merges
        assert_state_matches(t, r)
        tiers: dict = {}
        for _, _, cap, _ in live_counts(t.index):
            tiers[cap.bit_length()] = tiers.get(cap.bit_length(), 0) + 1
        assert all(v <= 2 for v in tiers.values()), tiers
    assert tr.stats.merges >= 1
    t.mark_deleted([N_SEALED + 49])
    r.mark_deleted([N_SEALED + 49])
    segs = t.index.segments()
    tr.merge_segments(segs[-2], segs[-1])
    rr.merge_segments(segs[-2], segs[-1])
    assert_state_matches(t, r)
    assert resolve_global_ids_pool(t.index, [N_SEALED + 49])[0][0] == -1  # reclaimed
    assert_search_close(t, r, corpus, [N_SEALED + 1, N_SEALED + 30, N_SEALED + 63, 7])
    with pytest.raises(ValueError):
        tr.merge_segments((0, 0), (0, 0))
    with pytest.raises(ValueError):
        tr.merge_segments((0, 0), (9, 9))


def test_background_merge_equals_synchronous(corpus, sealed):
    svc_bg, bg, _, _ = pair(sealed, **NO_COMPACT, tier_fanout=2)
    svc_sync, sync, _, _ = pair(sealed, **NO_COMPACT, tier_fanout=2, background_merge=False)
    for b in range(3):
        lo = N_SEALED + 16 * b
        for svc, router in ((svc_bg, bg), (svc_sync, sync)):
            svc.insert(to_torch(corpus.docs[lo:lo + 16]))
            router.compact_incremental()
        bg.wait_merges()
    assert sorted(c for _, _, c, _ in live_counts(bg.pool)) == \
        sorted(c for _, _, c, _ in live_counts(sync.pool))
    assert bg.stats.merges == sync.stats.merges >= 1
    bg.stop_merge_worker()
    bg.stop_merge_worker()  # idempotent
    svc_bg.insert(to_torch(corpus.docs[N_SEALED + 48:N_SEALED + 64]))
    bg.compact_incremental()  # restarts the worker
    bg.wait_merges()
    svc_bg.stop_pump()
    assert bg._merge_thread is None
    for doc in (N_SEALED + 1, N_SEALED + 60):
        res = svc_bg.search(to_torch(corpus.docs[doc:doc + 1]),
                            FusionSpec.make("weighted_sum", 1.0, 0.0, 0.0), k=5)
        assert int(res.ids[0, 0]) == doc


def test_auto_compact_on_threshold_matches_repro(corpus, sealed):
    t, tr, r, rr = pair(sealed, seal_threshold=24)
    insert_both(t, r, corpus, N_SEALED, N_SEALED + 16)
    assert tr.stats.compactions == rr.stats.compactions == 0
    insert_both(t, r, corpus, N_SEALED + 16, N_SEALED + 32)
    assert tr.stats.incremental_compactions == rr.stats.incremental_compactions == 1
    assert t.grow_index is None
    tr.wait_merges()
    rr.wait_merges()
    assert_state_matches(t, r)
    t.stop_pump()
    r.stop_pump()


def test_grow_shapes_stay_log_growth(corpus, sealed):
    t, tr, _, _ = pair(sealed, **NO_COMPACT)
    t.search(to_torch(corpus.queries[:4]), three_path(), k=5)
    sealed_keys = set(t.executable_cache)
    caps = []
    for b in range(6):
        lo = N_SEALED + 8 * b
        t.insert(to_torch(corpus.docs[lo:lo + 8]))
        res = t.search(to_torch(corpus.queries[:4]), three_path(), k=5)
        assert (res.ids.numpy() < N_SEALED + tr.grow_size).all()  # pad rows never surface
        caps.append(tr.grow_capacity)
        assert sealed_keys <= set(t.executable_cache)  # sealed keys survive every insert
    assert caps == [8, 16, 32, 32, 64, 64] and tr.grow_size == 48
    assert len(t.grow_shape_keys) == 4  # one per capacity, not per insert
    # tombstones land in the raw grow segment too: a later insert cannot
    # resurrect them
    t.mark_deleted([N_SEALED + 10])
    t.insert(to_torch(corpus.docs[N_SEALED + 48:N_SEALED + 56]))
    res = t.search(to_torch(corpus.docs[N_SEALED + 10:N_SEALED + 11]), three_path(), k=5)
    assert N_SEALED + 10 not in res.ids.numpy()


def test_pinned_global_ids_are_validated(corpus, sealed):
    t, tr, _, _ = pair(sealed, **NO_COMPACT)
    docs = to_torch(corpus.docs[N_SEALED:N_SEALED + 4])
    for bad in ([1000, 1001, 1002], [1000, 1002, 1001, 1003], [5, 6, 7, 8],
                [2**31, 2**31 + 1, 2**31 + 2, 2**31 + 3]):
        with pytest.raises(ValueError):
            tr.insert(docs, global_ids=bad)
    tr.insert(docs, global_ids=[1000, 1002, 1004, 1006])
    np.testing.assert_array_equal(t._snap.grow_gids.numpy(), [1000, 1002, 1004, 1006])
    t.mark_deleted([1004])
    assert tr.stats.deleted_grow == 1 and not bool(t.grow_index.alive[2])
    with pytest.raises(ValueError):
        tr.insert(docs, global_ids=[1006, 1007, 1008, 1009])  # below the next id


def test_reattached_router_never_reissues_grow_gids(corpus, sealed):
    t, _, _, _ = pair(sealed, **NO_COMPACT)
    t.insert(to_torch(corpus.docs[N_SEALED:N_SEALED + 32]))
    router2 = SegmentRouter(t, T_CFG, RouterConfig(**NO_COMPACT))
    assert router2._next_gid == N_SEALED + 32 and router2._grow_raw.n == 32
    t.insert(to_torch(corpus.docs[N_SEALED + 32:N_SEALED + 48]))
    gids = t._snap.grow_gids.numpy()
    assert len(set(gids.tolist())) == len(gids) and (np.diff(gids) > 0).all()


def test_kg_survives_insert_and_compaction(corpus):
    """A KG pool (small E): entity paths of docs inserted into a born grow
    segment are searchable at once and survive the incremental seal, as in
    repro's router."""
    n0 = 192
    docs = jax.tree.map(jnp.asarray, corpus.docs)
    seg = rpool.build_pool_segment(docs[:n0], np.arange(n0), R_CFG, key=jax.random.key(4),
                                   kg_triplets=corpus.kg.triplets,
                                   doc_entities=corpus.doc_entities[:n0],
                                   n_entities=corpus.kg.n_entities)
    r_pool = rpool.SegmentPool.from_segmented(seg)
    params = dict(k=8, iters=16, pool_size=64, use_kg=True)
    kg = dict(kg_triplets=corpus.kg.triplets, n_entities=corpus.kg.n_entities)
    cfg = dict(seal_threshold=10**9, compaction="incremental")
    r = rsvc.HybridSearchService(r_pool, RSearchParams(use_kernel=False, **params),
                                 rsvc.ServiceConfig(batcher=rbatcher.BatcherConfig(
                                     flush_size=2, max_batch=2)))
    rr = rrouter.SegmentRouter(r, R_CFG, rrouter.RouterConfig(**cfg), **kg)
    t = HybridSearchService(pool_from_arrays(r_pool, "cpu"), SearchParams(**params),
                            ServiceConfig(batcher=BatcherConfig(flush_size=2, max_batch=2)))
    with pytest.raises(ValueError, match="knowledge-graph"):
        SegmentRouter(t, T_CFG, RouterConfig(**cfg))
    tr = repro_router(t, T_CFG, RouterConfig(**cfg), **kg)
    w_t = FusionSpec.make("weighted_sum", 0.2, 0.2, 0.2, kg=2.0)
    w_r = RFusionSpec.make("weighted_sum", 0.2, 0.2, 0.2, kg=2.0)

    def hits(doc):
        ent = np.asarray([[doc]], np.int32)
        g = t.search(to_torch(corpus.queries[:1]), w_t, entities=ent, k=8).ids.numpy()[0]
        w = np.asarray(r.search(jax.tree.map(lambda a: jnp.asarray(a[:1]), corpus.queries),
                                w_r, entities=ent, k=8).ids)[0]
        return g, w

    for lo in (n0, n0 + 16):
        ents = corpus.doc_entities[lo:lo + 16]
        tr.insert(to_torch(corpus.docs[lo:lo + 16]), new_doc_entities=ents)
        rr.insert(jax.tree.map(lambda a: jnp.asarray(a[lo:lo + 16]), corpus.docs),
                  new_doc_entities=ents)
    np.testing.assert_array_equal(t.grow_index.logical_edges.numpy(),
                                  np.asarray(r.grow_index.logical_edges))
    for doc in (200, 220):
        g, w = hits(doc)
        assert doc in g and doc in w
    tr.compact_incremental()
    rr.compact_incremental()
    for doc in (220, 100):
        g, w = hits(doc)
        assert doc in g and doc in w
    np.testing.assert_array_equal(t.index.groups[-1].index.logical_edges.numpy(),
                                  np.asarray(r.index.groups[-1].index.logical_edges))
    with pytest.raises(ValueError, match="entity width"):
        tr.insert(to_torch(corpus.docs[n0:n0 + 2]), new_doc_entities=np.zeros((2, 99), np.int32))


def test_autocheckpoint_on_compaction(corpus, sealed, tmp_path):
    from repro_torch.checkpoint import load_pool

    ckpt = tmp_path / "auto"
    t, tr, _, _ = pair(sealed, **NO_COMPACT, auto_merge=False, autocheckpoint_every=2,
                       autocheckpoint_dir=str(ckpt))
    t.insert(to_torch(corpus.docs[N_SEALED:N_SEALED + 16]))
    tr.compact_incremental()
    assert tr.stats.autocheckpoints == 0  # 1 compaction < every=2
    t.insert(to_torch(corpus.docs[N_SEALED + 16:N_SEALED + 32]))
    tr.compact_incremental()
    assert tr.stats.autocheckpoints == 1
    loaded = load_pool(ckpt, device="cpu")
    assert loaded.capacities == tr.pool.capacities
    assert sum(c[3] for c in live_counts(loaded)) == N_SEALED + 32


def test_autocheckpoint_pairs_the_ingest_pipeline(corpus, sealed, tmp_path):
    from repro_torch.checkpoint import load_ingest
    from repro_torch.data.textcorpus import load_bundled_corpus
    from repro_torch.ingest import IngestConfig, IngestPipeline

    pipe = IngestPipeline(IngestConfig(d_dense=16), device="cpu")
    pipe.fit(load_bundled_corpus().texts[:40])
    ckpt = tmp_path / "auto"
    t, _, _, _ = pair(sealed, **NO_COMPACT)
    tr = SegmentRouter(t, T_CFG, RouterConfig(**NO_COMPACT, auto_merge=False,
                                              autocheckpoint_every=1,
                                              autocheckpoint_dir=str(ckpt)), ingest=pipe)
    t.insert(to_torch(corpus.docs[N_SEALED:N_SEALED + 16]))
    tr.compact_incremental()
    assert tr.stats.autocheckpoints == 1
    loaded = load_ingest(ckpt, device="cpu")
    assert loaded.entity_vocab.names == pipe.entity_vocab.names
    np.testing.assert_array_equal(loaded.stats.df_learned, pipe.stats.df_learned)
    assert (ckpt / "ingest_step_0").is_dir()


def test_pump_delivers_during_inserts(corpus, sealed):
    """Submissions racing an insert (a snapshot publish) all deliver through
    the pump alone."""
    t = HybridSearchService(
        pool_from_arrays(sealed, "cpu"), SearchParams(**PARAMS),
        ServiceConfig(batcher=BatcherConfig(flush_size=4, max_batch=4, flush_deadline_s=0.001,
                                            max_queue=4096), pump_interval_s=0.002))
    router = SegmentRouter(t, T_CFG, RouterConfig(**NO_COMPACT))
    try:
        t.insert(to_torch(corpus.docs[N_SEALED:N_SEALED + 32]))  # the grow segment exists
        pendings = []

        def client():
            for i in range(12):
                pendings.append(t.submit(SearchRequest(query=to_torch(corpus.queries)[i % 16],
                                                       fusion=three_path(), k=3)))
                time.sleep(0.002)

        th = threading.Thread(target=client)
        th.start()
        t.insert(to_torch(corpus.docs[N_SEALED + 32:N_SEALED + 48]))  # racing insert
        th.join()
        deadline = time.monotonic() + 60.0
        while not all(p.done for p in pendings) and time.monotonic() < deadline:
            time.sleep(0.005)
        assert len(pendings) == 12 and all(p.done for p in pendings)
        for p in pendings:
            assert p.result()[0].shape == (3,)
        assert router.stats.inserts == 2
    finally:
        t.stop_pump()
    assert t._pump_thread is None


def test_concurrent_writers_readers_and_merges_keep_ids_unique(corpus, sealed):
    """Four writer threads, two readers and the background merge worker on
    one service, with a short thread switch interval: every allocated id
    ends up exactly once in the pool or the grow segment, the grow map stays
    sorted, and no read fails."""
    import sys

    t = HybridSearchService(pool_from_arrays(sealed, "cpu"), SearchParams(**PARAMS),
                            ServiceConfig(batcher=BatcherConfig(flush_size=4, max_batch=4)))
    router = SegmentRouter(t, T_CFG, RouterConfig(seal_threshold=16, tier_fanout=2))
    errors, stop = [], threading.Event()

    def writer(w):
        try:
            for b in range(4):
                lo = N_SEALED + 32 * w + 8 * b
                t.insert(to_torch(corpus.docs[lo:lo + 8]))
        except Exception as e:  # noqa: BLE001 - asserted below
            errors.append(e)

    def reader():
        try:
            while not stop.is_set():
                t.search(to_torch(corpus.queries[:4]), three_path(), k=5)
        except Exception as e:  # noqa: BLE001 - asserted below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=writer, args=(w,)) for w in range(4)]
        readers = [threading.Thread(target=reader) for _ in range(2)]
        for th in threads + readers:
            th.start()
        for th in threads:
            th.join(timeout=300)
        stop.set()
        for th in readers:
            th.join(timeout=300)
        router.wait_merges(timeout_s=300)
    finally:
        sys.setswitchinterval(old)
        t.stop_pump()
    assert not errors, errors
    assert not any(th.is_alive() for th in threads + readers)
    assert router.stats.inserted_docs == 128
    ids = [g.global_ids.numpy().reshape(-1) for g in t.index.groups]
    if t._snap.grow_gids is not None:
        grow = t._snap.grow_gids.numpy()
        assert (np.diff(grow) > 0).all()
        ids.append(grow)
    ids = np.concatenate(ids)
    ids = ids[ids >= N_SEALED]
    assert len(ids) == len(set(ids.tolist())) == 128
    assert set(ids.tolist()) == set(range(N_SEALED, N_SEALED + 128))
