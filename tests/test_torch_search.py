"""The port's search (repro_torch.core.search) against repro's.

1. On an index repro built, carried across with convert.index_from_numpy:
   every fusion mode, with keywords and the KG each on and off. ids agree
   exactly up to score ties, scores and path scores to 1e-5, expanded exactly.
2. On an index the port built with its own draws: recall@10 against brute
   force and nDCG@10 within 0.02 of repro's; the keyword filter and the KG
   multi-hop gain of tests/test_search.py hold.
"""

from __future__ import annotations

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
from repro.core import build_index as r_build_index  # noqa: E402
from repro.core.search import SearchParams as RSearchParams  # noqa: E402
from repro.core.search import search as r_search  # noqa: E402
from repro.core.usms import weighted_query as r_weighted_query  # noqa: E402
from repro.data.corpus import CorpusConfig, make_corpus, ndcg_at_k, recall_at_k  # noqa: E402
from repro.kernels import ops as rops  # noqa: E402
from repro_torch.convert import fused_from_numpy, index_from_numpy  # noqa: E402
from repro_torch.core.build_pipeline import build_index  # noqa: E402
from repro_torch.core.fusion import FusionSpec  # noqa: E402
from repro_torch.core.index import BuildConfig, INDEX_FIELDS, mark_deleted  # noqa: E402
from repro_torch.core.knn_graph import KnnConfig  # noqa: E402
from repro_torch.core.pruning import PruneConfig  # noqa: E402
from repro_torch.core.search import SearchParams, search  # noqa: E402

TOL = 1e-5
SPECS = {
    "dense_only": dict(mode="weighted_sum", dense=1.0, sparse=0.0, full=0.0),
    "three_path": dict(mode="weighted_sum", dense=1.0, sparse=1.0, full=1.0),
    "custom": dict(mode="weighted_sum", dense=0.7, sparse=0.3, full=0.1),
    "minmax": dict(mode="minmax", dense=1.0, sparse=1.0, full=1.0),
    "zscore": dict(mode="zscore", dense=1.0, sparse=1.0, full=1.0),
    "rrf": dict(mode="rrf", dense=1.0, sparse=1.0, full=1.0),
}
KNN = dict(k=24, iters=4, node_chunk=512)
PRUNE = dict(degree=16, keyword_degree=8, node_chunk=256)
PARAMS = dict(k=10, iters=40, pool_size=48)


def to_torch(f):
    a = np.asarray
    return fused_from_numpy(a(f.dense), a(f.learned.idx), a(f.learned.val),
                            a(f.lexical.idx), a(f.lexical.val), "cpu")


def index_to_torch(index):
    c = index.corpus
    mapping = {f: np.asarray(getattr(index, f)) for f in INDEX_FIELDS}
    mapping["corpus"] = dict(
        dense=np.asarray(c.dense), learned_idx=np.asarray(c.learned.idx),
        learned_val=np.asarray(c.learned.val), lexical_idx=np.asarray(c.lexical.idx),
        lexical_val=np.asarray(c.lexical.val))
    return index_from_numpy(mapping, "cpu")


@pytest.fixture(scope="module")
def built():
    corpus = make_corpus(CorpusConfig(n_docs=512, n_queries=16, n_topics=16, d_dense=32,
                                      nnz_sparse=16, nnz_lexical=8, seed=5))
    docs = jax.tree.map(jnp.asarray, corpus.docs)
    kg = dict(kg_triplets=corpus.kg.triplets, doc_entities=corpus.doc_entities,
              n_entities=corpus.kg.n_entities)
    r_cfg = RBuildConfig(knn=RKnnConfig(use_kernel=False, **KNN),
                         prune=RPruneConfig(use_kernel=False, **PRUNE), path_refine_iters=2)
    r_index = r_build_index(docs, r_cfg, **kg)
    t_cfg = BuildConfig(knn=KnnConfig(**KNN), prune=PruneConfig(**PRUNE), path_refine_iters=2)
    t_index = build_index(to_torch(corpus.docs), t_cfg, generator=torch.Generator().manual_seed(9),
                          device="cpu", **kg)
    return corpus, r_index, index_to_torch(r_index), t_index


def run_both(built, spec_name, use_keywords, use_kg):
    corpus, r_idx, t_idx, _ = built
    kg_w = 30.0 if use_kg else 0.0
    s = SPECS[spec_name]
    r_spec = RFusionSpec.make(s["mode"], s["dense"], s["sparse"], s["full"], kg_w)
    t_spec = FusionSpec.make(s["mode"], s["dense"], s["sparse"], s["full"], kg_w)
    flags = dict(use_keywords=use_keywords, use_kg=use_kg)
    extra = dict(keywords=corpus.query_keywords, entities=corpus.query_entities)
    want = r_search(r_idx, jax.tree.map(jnp.asarray, corpus.queries), r_spec,
                    RSearchParams(use_kernel=False, **PARAMS, **flags),
                    keywords=jnp.asarray(extra["keywords"]),
                    entities=jnp.asarray(extra["entities"]))
    got = search(t_idx, to_torch(corpus.queries), t_spec, SearchParams(**PARAMS, **flags),
                 device="cpu", **extra)
    return got, want


@pytest.mark.parametrize("use_kg", [False, True])
@pytest.mark.parametrize("use_keywords", [False, True])
@pytest.mark.parametrize("spec_name", list(SPECS))
def test_search_on_repro_index_matches_repro(built, spec_name, use_keywords, use_kg):
    got, want = run_both(built, spec_name, use_keywords, use_kg)
    gi, wi = got.ids.numpy(), np.asarray(want.ids)
    gs, ws = got.scores.numpy(), np.asarray(want.scores)
    np.testing.assert_allclose(gs, ws, rtol=TOL, atol=TOL)
    flip = gi != wi
    assert np.all(np.abs(gs - ws)[flip] <= TOL), f"ids diverged beyond ties:\n{gi}\n{wi}"
    np.testing.assert_allclose(got.path_scores.numpy(), np.asarray(want.path_scores),
                               rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got.expanded.numpy(), np.asarray(want.expanded))


def _quality(corpus, ids, spec):
    qw = r_weighted_query(jax.tree.map(jnp.asarray, corpus.queries), spec.weights)
    _, truth = jax.lax.top_k(rops.pairwise_scores_chunked(qw, jax.tree.map(jnp.asarray,
                                                                           corpus.docs)), 10)
    return recall_at_k(ids, np.asarray(truth)), ndcg_at_k(ids, corpus.query_relevant, 10)


@pytest.mark.parametrize("spec_name", ["dense_only", "three_path", "rrf"])
def test_port_built_index_recall_matches_repro(built, spec_name):
    corpus, r_index, _, t_index = built
    s = SPECS[spec_name]
    r_spec = RFusionSpec.make(s["mode"], s["dense"], s["sparse"], s["full"])
    t_spec = FusionSpec.make(s["mode"], s["dense"], s["sparse"], s["full"])
    wide = dict(k=10, iters=96, pool_size=96)  # near-exhaustive at N = 512
    want = r_search(r_index, jax.tree.map(jnp.asarray, corpus.queries), r_spec,
                    RSearchParams(use_kernel=False, **wide))
    got = search(t_index, to_torch(corpus.queries), t_spec, SearchParams(**wide), device="cpu")
    r_rec, r_nd = _quality(corpus, np.asarray(want.ids), r_spec)
    t_rec, t_nd = _quality(corpus, got.ids.numpy(), r_spec)
    assert abs(t_rec - r_rec) <= 0.02, (t_rec, r_rec)
    assert abs(t_nd - r_nd) <= 0.02, (t_nd, r_nd)


def test_port_built_index_keyword_filter_honored(built):
    corpus, _, _, t_index = built
    res = search(t_index, to_torch(corpus.queries), FusionSpec.three_path(),
                 SearchParams(k=5, iters=48, pool_size=64, use_keywords=True),
                 keywords=corpus.query_keywords, device="cpu")
    f_idx = np.asarray(corpus.docs.lexical.idx)
    for req, row in zip(corpus.query_keywords, res.ids.numpy()):
        req = set(req[req >= 0].tolist())
        if req:
            for d in row[row >= 0]:
                assert req & set(f_idx[d][f_idx[d] >= 0].tolist())


def test_port_built_index_kg_multihop_improves(built):
    corpus, _, _, t_index = built
    truth = corpus.query_multihop_target[:, None]
    q = to_torch(corpus.queries)
    base = search(t_index, q, FusionSpec.three_path(), SearchParams(k=10, iters=48, pool_size=64),
                  device="cpu")
    kg = search(t_index, q, FusionSpec.weighted(1.0, 1.0, 1.0, kg=30.0),
                SearchParams(k=10, iters=48, pool_size=64, use_kg=True),
                entities=corpus.query_entities, device="cpu")
    assert recall_at_k(kg.ids, truth) > recall_at_k(base.ids, truth) + 0.1


def test_mark_deleted_filters_results(built):
    corpus, _, t_idx, _ = built
    q = to_torch(corpus.queries)
    res = search(t_idx, q, FusionSpec.three_path(), SearchParams(**PARAMS), device="cpu")
    victim = int(res.ids[0, 0])
    pruned = mark_deleted(t_idx, [victim, -1])
    assert bool(t_idx.alive[victim]) and not bool(pruned.alive[victim])
    assert int(pruned.alive.sum()) == t_idx.n - 1
    res2 = search(pruned, q, FusionSpec.three_path(), SearchParams(**PARAMS), device="cpu")
    assert victim not in res2.ids[0].tolist()
