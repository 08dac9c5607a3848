"""The port's build stages (repro_torch.core) against repro's, each fed
repro's own inputs, and the whole build under repro's random draws. Edges
are compared row by row as sets: NN-Descent can turn a 1-ulp score flip into
another neighbor, so the whole build is held to >= 99% equal rows."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small tensors: threads only contend with the other workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import build_pipeline as rbp  # noqa: E402
from repro.core import knn_graph as rknn  # noqa: E402
from repro.core import logical_edges as rlog  # noqa: E402
from repro.core import pruning as rpr  # noqa: E402
from repro.core.index import BuildConfig as RBuildConfig  # noqa: E402
from repro.core.knn_graph import KnnConfig as RKnnConfig  # noqa: E402
from repro.core.pruning import PruneConfig as RPruneConfig  # noqa: E402
from repro.data.corpus import CorpusConfig as RCorpusConfig  # noqa: E402
from repro.data.corpus import make_corpus as r_make_corpus  # noqa: E402
from repro_torch.convert import fused_from_numpy  # noqa: E402
from repro_torch.core import build_pipeline as tbp  # noqa: E402
from repro_torch.core import knn_graph as tknn  # noqa: E402
from repro_torch.core import logical_edges as tlog  # noqa: E402
from repro_torch.core import pruning as tpr  # noqa: E402
from repro_torch.core.index import BuildConfig  # noqa: E402
from repro_torch.core.knn_graph import KnnConfig  # noqa: E402
from repro_torch.core.pruning import PruneConfig  # noqa: E402
from repro_torch.data.corpus import CorpusConfig, make_corpus  # noqa: E402
from tests.helpers import random_fused  # noqa: E402

N = 384
KNN = dict(k=16, iters=3, node_chunk=256)
PRUNE = dict(degree=12, keyword_degree=6, node_chunk=128)
R_CFG = RBuildConfig(knn=RKnnConfig(use_kernel=False, **KNN),
                     prune=RPruneConfig(use_kernel=False, **PRUNE), path_refine_iters=2)
T_CFG = BuildConfig(knn=KnnConfig(**KNN), prune=PruneConfig(**PRUNE), path_refine_iters=2)
KEY = jax.random.key(0)


def t(a):
    return torch.as_tensor(np.array(a))


def to_torch(f):
    a = np.asarray
    return fused_from_numpy(a(f.dense), a(f.learned.idx), a(f.learned.val),
                            a(f.lexical.idx), a(f.lexical.val), "cpu")


def rows_equal_as_sets(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    same = [set(x[x >= 0].tolist()) == set(y[y >= 0].tolist()) for x, y in zip(a, b)]
    return float(np.mean(same))


def repro_draws(n: int, cfg: RBuildConfig, key) -> tbp.BuildDraws:
    """The random tables repro's build_index draws from ``key``: the init
    graph and round tables of _descent_init/_descent_rounds, and the three
    per-path chains from fold_in(key, 1..3) (build_pipeline.py:149-188, 289)."""
    r = cfg.knn.extra_random
    key_r, k0 = jax.random.split(key)
    init = rknn._init_graph(n, cfg.knn.k, k0)
    rounds = []
    for _ in range(cfg.knn.iters):
        key_r, kr = jax.random.split(key_r)
        rounds.append(jax.random.randint(kr, (n, r), 0, n, dtype=jnp.int32))
    assert cfg.knn.k >= max(rbp._graph_pk(cfg), 12), "refinement must not widen the graph"
    path_rounds = []
    for i in (1, 2, 3):
        key_p, _ = jax.random.split(jax.random.fold_in(key, i))
        tables = []
        for _ in range(cfg.path_refine_iters):
            key_p, kr = jax.random.split(key_p)
            tables.append(t(jax.random.randint(kr, (n, r), 0, n, dtype=jnp.int32)))
        path_rounds.append(tables)
    return tbp.BuildDraws(init_graph=t(init), rounds=[t(x) for x in rounds],
                          path_rounds=path_rounds)


@pytest.fixture(scope="module")
def ref():
    c = r_make_corpus(RCorpusConfig(n_docs=N, n_queries=8, n_topics=12, d_dense=32,
                                    nnz_sparse=16, nnz_lexical=8, seed=1))
    docs = jax.tree.map(jnp.asarray, c.docs)
    g = rbp.build_graph(docs, R_CFG, KEY)
    index = rbp.build_index(docs, R_CFG, key=KEY, kg_triplets=c.kg.triplets,
                            doc_entities=c.doc_entities, n_entities=c.kg.n_entities)
    path_ids = rbp._path_refinement(docs, g.knn_ids, KEY, R_CFG, rbp._graph_pk(R_CFG))
    return c, docs, to_torch(c.docs), g, index, path_ids


def test_descent_round_chunk_matches_repro(ref):
    _, docs, tdocs, g, _, _ = ref
    cfg_r = dataclasses.replace(R_CFG.knn)
    rng = np.random.default_rng(2)
    rand = rng.integers(0, N, size=(128, cfg_r.extra_random)).astype(np.int32)
    nbr, sc = g.knn_ids, g.knn_scores
    want_ids, want_sc = rknn._descent_round_chunk(
        docs, nbr, docs[slice(0, 128)], jnp.arange(128, dtype=jnp.int32), nbr[:128], sc[:128],
        jnp.asarray(rand), cfg_r)
    got_ids, got_sc = tknn._descent_round_chunk(
        tdocs, t(nbr), tdocs[0:128], torch.arange(128, dtype=torch.int32), t(nbr)[:128],
        t(sc)[:128], t(rand), T_CFG.knn)
    np.testing.assert_allclose(got_sc.numpy(), np.asarray(want_sc), rtol=1e-5, atol=1e-5)
    assert rows_equal_as_sets(got_ids, want_ids) == 1.0


def test_reverse_neighbors_matches_repro(ref):
    _, _, _, g, _, _ = ref
    ids = np.asarray(g.knn_ids).copy()
    ids[::7, -3:] = -1  # PAD slots are skipped
    for cap in (1, 3, 8):
        want = np.asarray(rknn.reverse_neighbors(jnp.asarray(ids), cap))
        np.testing.assert_array_equal(tknn.reverse_neighbors(t(ids), cap).numpy(), want)


def test_dedup_mask_matches_repro():
    rng = np.random.default_rng(4)
    ids = rng.integers(-1, 9, size=(5, 20)).astype(np.int32)
    want = np.stack([np.asarray(rknn.dedup_mask(jnp.asarray(r))) for r in ids])
    np.testing.assert_array_equal(tknn.dedup_mask(t(ids)).numpy(), want)


@pytest.mark.parametrize("with_paths", [True, False])
def test_prune_all_matches_repro(ref, with_paths):
    """RNG-IP pruning + keyword recycling on repro's kNN graph, self scores
    and per-path picks (or the per-path fallback)."""
    _, docs, tdocs, g, _, path_ids = ref
    pids = path_ids if with_paths else None
    want_sem, want_kw = rbp._prune_all(docs, g.knn_ids, g.knn_scores, g.self_ip, pids,
                                       R_CFG.prune)
    got_sem, got_kw = tpr.prune_all(tdocs, t(g.knn_ids), t(g.knn_scores), t(g.self_ip),
                                     None if pids is None else t(pids), T_CFG.prune)
    assert rows_equal_as_sets(got_sem, want_sem) == 1.0
    assert rows_equal_as_sets(got_kw, want_kw) == 1.0
    np.testing.assert_array_equal(got_sem.numpy(), np.asarray(want_sem))


@pytest.mark.parametrize("mode", ["rng", "ip"])
def test_prune_ablation_modes_match_repro(ref, mode):
    _, docs, tdocs, g, _, path_ids = ref
    rc = dataclasses.replace(R_CFG.prune, mode=mode)
    tc = dataclasses.replace(T_CFG.prune, mode=mode)
    want_sem, _ = rbp._prune_all(docs, g.knn_ids, g.knn_scores, g.self_ip, path_ids, rc)
    got_sem, _ = tpr.prune_all(tdocs, t(g.knn_ids), t(g.knn_scores), t(g.self_ip),
                                t(path_ids), tc)
    assert rows_equal_as_sets(got_sem, want_sem) == 1.0


def test_self_scores_and_entry_points_match_repro(ref):
    """Entry points on a corpus with spread-out norms (make_corpus's dense
    rows are unit vectors, whose dense-path norms tie to within an ulp)."""
    _, _, tdocs, g, _, _ = ref
    sip = tpr.self_scores(tdocs)
    np.testing.assert_allclose(sip.numpy(), np.asarray(g.self_ip), rtol=1e-5, atol=1e-5)
    corpus = random_fused(np.random.default_rng(8), (200,), d_dense=24, ps=9, pf=5)
    jc, tc = jax.tree.map(jnp.asarray, corpus), to_torch(corpus)
    r_sip = rpr.self_scores(jc, use_kernel=False)
    for n_entry in (5, 16):
        want = np.asarray(rbp._entry_points(jc, r_sip, n_entry, False))
        got = tbp._entry_points(tc, tpr.self_scores(tc), n_entry, None).numpy()
        np.testing.assert_array_equal(got, want)


def test_logical_edges_match_repro(ref):
    c = ref[0]
    want = rlog.build_logical_edges(c.kg.triplets, c.doc_entities, c.kg.n_entities, 6, 4)
    got = tlog.build_logical_edges(c.kg.triplets, c.doc_entities, c.kg.n_entities, 6, 4)
    for f in ("edges", "entity_to_docs", "entity_adj", "doc_entities"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


def test_unique_take_pads_to_width():
    ids = torch.tensor([[9, 3, 9, -1]], dtype=torch.int32)
    got = tpr.unique_take(ids, torch.zeros(ids.shape), 6)
    np.testing.assert_array_equal(got.numpy(), [[9, 3, -1, -1, -1, -1]])
    rng = np.random.default_rng(3)
    for _ in range(20):  # where len(ids) >= width repro agrees
        row = rng.integers(-1, 6, size=10).astype(np.int32)
        want = np.asarray(rpr.unique_take(jnp.asarray(row), jnp.zeros(10), 4))
        np.testing.assert_array_equal(tpr.unique_take(t(row)[None], torch.zeros(1, 10), 4)[0], want)


def test_whole_build_under_shared_draws_matches_repro(ref):
    c, _, tdocs, g, index, _ = ref
    draws = repro_draws(N, R_CFG, KEY)
    report = {}
    got = tbp.build_index(tdocs, T_CFG, draws=draws, kg_triplets=c.kg.triplets,
                          doc_entities=c.doc_entities, n_entities=c.kg.n_entities,
                          device="cpu", report=report)
    assert rows_equal_as_sets(report["knn_ids"], g.knn_ids) >= 0.99
    assert rows_equal_as_sets(got.semantic_edges, index.semantic_edges) >= 0.99
    assert rows_equal_as_sets(got.keyword_edges, index.keyword_edges) >= 0.99
    # the dense-path part of the entry set ranks unit vectors by norm: ties
    # within an ulp, so only the other three parts must agree
    per = -(-R_CFG.n_entry // 4)
    shared = set(got.entry_points.tolist()) & set(np.asarray(index.entry_points).tolist())
    assert len(shared) >= R_CFG.n_entry - per
    for f in ("logical_edges", "doc_entities", "entity_to_docs", "entity_adj", "alive"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(index, f)))
    np.testing.assert_allclose(got.self_ip.numpy(), np.asarray(index.self_ip), atol=1e-5)
    assert set(report["stage_seconds"]) == {"descent", "refinement", "prune", "entry_points",
                                            "logical_edges"}


def test_own_draws_build_is_well_formed(ref):
    tdocs = ref[2]
    gen = torch.Generator().manual_seed(3)
    index = tbp.build_index(tdocs, T_CFG, generator=gen, device="cpu")
    sem = index.semantic_edges.numpy()
    assert sem.shape == (N, PRUNE["degree"])
    assert ((sem >= -1) & (sem < N)).all()
    assert not (sem == np.arange(N)[:, None]).any()
    for row in sem:
        live = row[row >= 0]
        assert len(live) > 0 and len(set(live.tolist())) == len(live)
    assert index.nbytes() > 0 and index.edge_nbytes()["semantic"] == sem.nbytes


def test_port_make_corpus_properties():
    cfg = CorpusConfig(n_docs=600, n_queries=24, n_topics=10, d_dense=16, nnz_sparse=12,
                       nnz_lexical=6, seed=4)
    c = make_corpus(cfg, device="cpu")
    for sv, cap in ((c.docs.learned, 12), (c.docs.lexical, 6), (c.queries.learned, 16),
                    (c.queries.lexical, 8)):
        idx, val = sv.idx.numpy(), sv.val.numpy()
        assert idx.shape[1] == cap
        np.testing.assert_array_equal(idx < 0, val == 0)  # PAD contract
        for row in idx:
            live = row[row >= 0]
            assert len(set(live.tolist())) == len(live)  # unique ids per row
    np.testing.assert_allclose(np.linalg.norm(c.docs.dense.numpy(), axis=1), 1.0, atol=1e-5)
    # planted relevant docs: distinct, from the query's topic where it has enough members
    for rel in c.query_relevant:
        assert len(set(rel.tolist())) == cfg.relevant_per_query
    topics = c.doc_topics[c.query_relevant]
    assert (topics == topics[:, :1]).all()
    # required keyword, when set, is shared by every relevant doc
    lex = c.docs.lexical.idx.numpy()
    for kw, rel in zip(c.query_keywords[:, 0], c.query_relevant):
        if kw >= 0:
            assert all(kw in lex[d] for d in rel)
    # KG chains: the multi-hop tail is reachable from the query entity
    adj = {}
    for s, _, d in c.kg.triplets:
        adj.setdefault(int(s), set()).add(int(d))
    for head, tail in zip(c.query_entities[:, 0], c.query_multihop_target):
        frontier, seen = {int(head)}, {int(head)}
        for _ in range(cfg.chain_len - 1):
            frontier = {d for s in frontier for d in adj.get(s, ())} - seen
            seen |= frontier
        assert int(tail) in seen
    ents = c.doc_entities
    np.testing.assert_array_equal(ents[:, 0], np.arange(600))
    common = ents[:, 1:]
    assert ((common == -1) | ((common >= 600) & (common < cfg.n_entities))).all()
