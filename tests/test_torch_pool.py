"""The port's segment pool (repro_torch.core.segment_pool / distributed)
against repro's on the same docs: segments built under repro's random draws,
appended into shape groups, tombstoned, routed, extracted, removed and
compacted; the int8 seal; and the single-device group search in every
fusion mode. Corpus rows, global ids and alive masks are equal exactly;
graph edges as row sets in >= 99% of rows (a 1-ulp score flip can pick
another neighbor); search ids up to ties with scores to 1e-4."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small tensors: threads only contend with the other workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import BuildConfig as RBuildConfig  # noqa: E402
from repro.core import FusionSpec as RFusionSpec  # noqa: E402
from repro.core import KnnConfig as RKnnConfig  # noqa: E402
from repro.core import PruneConfig as RPruneConfig  # noqa: E402
from repro.core import distributed as rdist  # noqa: E402
from repro.core import segment_pool as rpool  # noqa: E402
from repro.core.search import SearchParams as RSearchParams  # noqa: E402
from repro.data.corpus import CorpusConfig, make_corpus  # noqa: E402
from repro_torch.convert import fused_from_numpy, segmented_from_arrays  # noqa: E402
from repro_torch.core import distributed as tdist  # noqa: E402
from repro_torch.core import segment_pool as tpool  # noqa: E402
from repro_torch.core.fusion import FusionSpec  # noqa: E402
from repro_torch.core.index import BuildConfig  # noqa: E402
from repro_torch.core.knn_graph import KnnConfig  # noqa: E402
from repro_torch.core.pruning import PruneConfig  # noqa: E402
from repro_torch.core.search import SearchParams  # noqa: E402
from repro_torch.core.usms import QuantizedFusedVectors  # noqa: E402
from tests.test_torch_build import repro_draws, rows_equal_as_sets  # noqa: E402

KNN = dict(k=12, iters=2, node_chunk=128)
PRUNE = dict(degree=8, keyword_degree=3, node_chunk=64)
R_CFG = RBuildConfig(knn=RKnnConfig(use_kernel=False, **KNN),
                     prune=RPruneConfig(use_kernel=False, **PRUNE), path_refine_iters=1)
T_CFG = BuildConfig(knn=KnnConfig(**KNN), prune=PruneConfig(**PRUNE), path_refine_iters=1)
# (lo, hi, capacity, key): two segments share capacity 128 (one group), the
# third has capacity 64 (a second group)
SEGMENTS = ((0, 96, 128, 1), (96, 192, 128, 2), (192, 240, 64, 3))
DELETE = [3, 100, 200, 239, 999, -1]  # live ids, an unknown id and PAD
TOL = 1e-4


def to_torch(f):
    a = np.asarray
    return fused_from_numpy(a(f.dense), a(f.learned.idx), a(f.learned.val),
                            a(f.lexical.idx), a(f.lexical.val), "cpu")


def host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_corpus_equal(got, want):
    names = (("dense_q", "dense_scale") if isinstance(got, QuantizedFusedVectors)
             else ("dense",))
    for n in names:
        np.testing.assert_array_equal(host(getattr(got, n)), host(getattr(want, n)))
    for p in ("learned", "lexical"):
        for f in ("idx", "val"):
            np.testing.assert_array_equal(host(getattr(getattr(got, p), f)),
                                          host(getattr(getattr(want, p), f)))


def assert_group_matches(got: tdist.SegmentedIndex, want, edges=0.99):
    np.testing.assert_array_equal(host(got.global_ids), host(want.global_ids))
    np.testing.assert_array_equal(host(got.index.alive), host(want.index.alive))
    assert_corpus_equal(got.index.corpus, want.index.corpus)
    assert got.index.entry_points.shape == tuple(want.index.entry_points.shape)
    for f in ("semantic_edges", "keyword_edges"):
        g, w = host(getattr(got.index, f)), host(getattr(want.index, f))
        assert g.shape == w.shape
        assert rows_equal_as_sets(g.reshape(-1, g.shape[-1]), w.reshape(-1, w.shape[-1])) >= edges


@pytest.fixture(scope="module")
def pools():
    corpus = make_corpus(CorpusConfig(n_docs=256, n_queries=8, n_topics=8, d_dense=16,
                                      nnz_sparse=8, nnz_lexical=6, seed=41))
    docs = jax.tree.map(jnp.asarray, corpus.docs)
    r_pool, t_pool = rpool.SegmentPool(groups=[]), tpool.SegmentPool(groups=[])
    r_segs, t_segs, touched = [], [], []
    for lo, hi, cap, key in SEGMENTS:
        gids = np.arange(lo, hi, dtype=np.int32)
        rs = rpool.build_pool_segment(docs[lo:hi], gids, R_CFG, capacity=cap,
                                      key=jax.random.key(key))
        ts = tpool.build_pool_segment(to_torch(corpus.docs[lo:hi]), gids, T_CFG, capacity=cap,
                                      draws=repro_draws(hi - lo, R_CFG, jax.random.key(key)),
                                      device="cpu")
        r_pool, rg = rpool.append_segment(r_pool, rs)
        t_pool, tg = tpool.append_segment(t_pool, ts)
        r_segs.append(rs)
        t_segs.append(ts)
        touched.append((rg, tg))
    return corpus, r_pool, t_pool, r_segs, t_segs, touched


def test_build_pool_segment_matches_repro(pools):
    _, _, _, r_segs, t_segs, _ = pools
    for rs, ts in zip(r_segs, t_segs):
        assert ts.n_segments == 1
        assert_group_matches(ts, rs)


def test_append_segment_groups_match_repro(pools):
    _, r_pool, t_pool, _, _, touched = pools
    assert [t for _, t in touched] == [r for r, _ in touched] == [0, 0, 1]
    assert t_pool.n_groups == r_pool.n_groups == 2
    assert t_pool.capacities == r_pool.capacities == (128, 64)
    assert t_pool.segments() == r_pool.segments()
    assert t_pool.max_global_id() == r_pool.max_global_id() == 239
    assert t_pool.entity_width == r_pool.entity_width
    assert t_pool.has_kg == r_pool.has_kg
    for tg, rg in zip(t_pool.groups, r_pool.groups):
        assert_group_matches(tg, rg)
    keys = {tpool.group_shape_key(g) for g in t_pool.groups}
    assert len(keys) == 2


def test_pool_routing_matches_repro(pools):
    _, r_pool, t_pool, _, _, _ = pools
    ids = np.array([0, 95, 96, 191, 192, 239, 240, 5000, -1, 17])
    for g, w in zip(tpool.resolve_global_ids_pool(t_pool, ids),
                    rpool.resolve_global_ids_pool(r_pool, ids)):
        np.testing.assert_array_equal(g, w)
    assert tpool.live_counts(t_pool) == rpool.live_counts(r_pool)
    ents = np.arange(12, dtype=np.int32).reshape(4, 3)
    for width in (1, 3, 5):
        np.testing.assert_array_equal(tpool.widen_entities(ents, width),
                                      rpool.widen_entities(ents, width))
    wrapped = tpool.SegmentPool.from_segmented(t_pool.groups[0])
    assert wrapped.groups[0] is t_pool.groups[0] and wrapped.n_segments == 2


def test_mark_deleted_and_alive_docs_match_repro(pools):
    _, r_pool, t_pool, _, _, _ = pools
    r_del = rpool.mark_deleted_pool(r_pool, np.asarray(DELETE))
    t_del = tpool.mark_deleted_pool(t_pool, np.asarray(DELETE))
    for tg, rg in zip(t_del.groups, r_del.groups):
        np.testing.assert_array_equal(host(tg.index.alive), host(rg.index.alive))
    assert bool(t_pool.groups[0].index.alive[0, 3])  # copy-on-write: the old pool is intact
    assert tpool.live_counts(t_del) == rpool.live_counts(r_del)
    assert sum(c[3] for c in tpool.live_counts(t_del)) == 240 - 4
    (gc, gg, ge), (wc, wg, we) = tpool.alive_docs_pool(t_del), rpool.alive_docs_pool(r_del)
    assert_corpus_equal(gc, wc)
    np.testing.assert_array_equal(gg, wg)
    np.testing.assert_array_equal(ge, we)
    for g, s in ((0, 1), (1, 0)):
        got, want = tpool.extract_segment_docs(t_del, g, s), rpool.extract_segment_docs(
            r_del, g, s)
        assert_corpus_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_remove_segments_matches_repro(pools):
    _, r_pool, t_pool, _, _, _ = pools
    for picks in ([(0, 0)], [(1, 0)], [(0, 1), (1, 0)]):
        got, want = tpool.remove_segments(t_pool, picks), rpool.remove_segments(r_pool, picks)
        assert got.capacities == want.capacities
        for tg, rg in zip(got.groups, want.groups):
            np.testing.assert_array_equal(host(tg.global_ids), host(rg.global_ids))
            assert_corpus_equal(tg.index.corpus, rg.index.corpus)
    assert tpool.remove_segments(t_pool, [(1, 0)]).groups[0] is t_pool.groups[0]


def test_compact_segmented_index_matches_repro(pools):
    _, r_pool, t_pool, _, _, _ = pools
    corpus_r, gids, ents = rpool.alive_docs_pool(rpool.mark_deleted_pool(r_pool, DELETE))
    corpus_t, gids_t, _ = tpool.alive_docs_pool(tpool.mark_deleted_pool(t_pool, DELETE))
    key = jax.random.key(5)
    want = rdist.compact_segmented_index(corpus_r, gids, 2, R_CFG, key=key)
    per = -(-corpus_t.n // 2)
    sizes = [min(per, corpus_t.n - s * per) for s in range(2)]
    draws = [repro_draws(per, R_CFG, jax.random.fold_in(key, s)) for s in range(2)]
    got = tdist.compact_segmented_index(corpus_t, gids_t, 2, T_CFG, draws=draws, device="cpu")
    assert sizes == [118, 118]
    assert_group_matches(got, want)
    seg, loc = tdist.resolve_global_ids(got, np.array([3, 4, 239, 238]))
    np.testing.assert_array_equal(seg[[0, 2]], -1)  # compacted away
    assert (seg[[1, 3]] >= 0).all()
    with pytest.raises(ValueError):
        tdist.compact_segmented_index(corpus_t[0:0], gids_t[:0], 2, T_CFG, device="cpu")


def test_int8_pool_segment_matches_repro(pools):
    corpus = pools[0]
    lo, hi, cap, key = SEGMENTS[2]
    gids = np.arange(lo, hi, dtype=np.int32)
    want = rpool.build_pool_segment(jax.tree.map(jnp.asarray, corpus.docs[lo:hi]), gids, R_CFG,
                                    capacity=cap, key=jax.random.key(key), corpus_dtype="int8")
    got = tpool.build_pool_segment(to_torch(corpus.docs[lo:hi]), gids, T_CFG, capacity=cap,
                                   draws=repro_draws(hi - lo, R_CFG, jax.random.key(key)),
                                   corpus_dtype="int8", device="cpu")
    assert isinstance(got.index.corpus, QuantizedFusedVectors)
    assert_group_matches(got, want)
    # an int8 segment never joins an fp32 group of the same capacity
    pool, g = tpool.append_segment(pools[2], got)
    assert g == 2 and pool.n_groups == 3
    with pytest.raises(ValueError):
        tpool.build_pool_segment(to_torch(corpus.docs[lo:hi]), gids, T_CFG, capacity=10,
                                 device="cpu")
    with pytest.raises(ValueError):
        tpool.build_pool_segment(to_torch(corpus.docs[lo:hi]), gids, T_CFG,
                                 corpus_dtype="int4", device="cpu")


@pytest.mark.parametrize("quantized", [False, True])
def test_local_group_search_matches_repro(pools, quantized):
    """The two-segment group of repro's pool, converted, searched by both
    packages' local group search in all four fusion modes (one batch:
    modes and weights are per-row data), keywords on."""
    corpus, r_pool, _, _, _, _ = pools
    group = r_pool.groups[0]
    if quantized:
        group = dataclasses.replace(group, index=dataclasses.replace(
            group.index, corpus=jax.vmap(rpool.quantize_corpus)(group.index.corpus)))
    t_group = segmented_from_arrays(group, "cpu")
    b = 8
    modes = ["weighted_sum", "minmax", "zscore", "rrf"] * 2
    specs_r = [RFusionSpec.make(m, 1.0, 0.6, 0.3 + i / 10) for i, m in enumerate(modes)]
    specs_t = [FusionSpec.make(m, 1.0, 0.6, 0.3 + i / 10) for i, m in enumerate(modes)]
    stack_r = jax.tree.map(lambda *xs: jnp.stack(xs), *[
        dataclasses.replace(s, stats=rdist.PathStats.identity()) for s in specs_r])
    from repro_torch.core.fusion import PathStats, stack_specs

    stack_t = stack_specs([dataclasses.replace(s, stats=PathStats.identity()) for s in specs_t])
    kw = np.full((b, 2), -1, np.int32)
    kw[::2, 0] = np.asarray(corpus.docs.lexical.idx)[:b:2, 0]
    ent = np.full((b, 1), -1, np.int32)
    params = dict(k=6, iters=24, pool_size=32, use_keywords=True,
                  corpus_dtype="int8" if quantized else "float32")
    q = jax.tree.map(lambda a: jnp.asarray(a[:b]), corpus.queries)
    want = rdist.make_local_group_search(RSearchParams(use_kernel=False, **params))(
        group, q, stack_r, jnp.asarray(kw), jnp.asarray(ent))
    got = tdist.make_local_group_search(SearchParams(**params))(
        t_group, to_torch(corpus.queries[:b]), stack_t, torch.as_tensor(kw), torch.as_tensor(ent))
    gi, wi = got.ids.numpy(), np.asarray(want.ids)
    gs, ws = got.scores.numpy(), np.asarray(want.scores)
    np.testing.assert_allclose(gs, ws, rtol=TOL, atol=TOL)
    assert np.all(np.abs(gs - ws)[gi != wi] <= TOL), f"ids diverged beyond ties:\n{gi}\n{wi}"
    np.testing.assert_allclose(got.path_scores.numpy(), np.asarray(want.path_scores),
                               rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got.expanded.numpy(), np.asarray(want.expanded))
    assert set(gi[gi >= 0].tolist()) <= set(range(192))  # global ids of group 0
