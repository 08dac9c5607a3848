"""The core's public names that the port's build pipeline does not use
(``repro.core.__all__``): the host-driven ``build_knn_graph`` and
``rng_ip_prune`` that repro keeps as its pipeline's reference, ``knn_recall``
and the three USMS helpers ``sparse_from_dense``, ``sparse_to_dense`` and
``concat_dense``, each against repro's on the same inputs; and the package
exports themselves.

``build_knn_graph`` runs from the same ``init_ids`` and repro's own round
draws (``rounds=``), so the graphs are held as in tests/test_torch_build.py:
rows equal as sets (>= 99%: a 1-ulp score flip can pick another neighbor)
and scores to 1e-5.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small tensors: threads only contend with the other workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as rcore  # noqa: E402
from repro.core import knn_graph as rknn  # noqa: E402
from repro.core import pruning as rpr  # noqa: E402
from repro.core import usms as rusms  # noqa: E402
from repro.core.knn_graph import KnnConfig as RKnnConfig  # noqa: E402
from repro.core.pruning import PruneConfig as RPruneConfig  # noqa: E402
from repro.core.usms import PathWeights as RPathWeights  # noqa: E402
from repro.data.corpus import CorpusConfig as RCorpusConfig  # noqa: E402
from repro.data.corpus import make_corpus as r_make_corpus  # noqa: E402
from repro_torch.convert import fused_from_numpy  # noqa: E402
from repro_torch.core import knn_graph as tknn  # noqa: E402
from repro_torch.core import pruning as tpr  # noqa: E402
from repro_torch.core import usms as tusms  # noqa: E402
from repro_torch.core.knn_graph import KnnConfig  # noqa: E402
from repro_torch.core.pruning import PruneConfig  # noqa: E402

N = 384
KNN = dict(k=16, iters=3, node_chunk=256)
PRUNE = dict(degree=12, keyword_degree=6, node_chunk=128)


def t(a):
    return torch.as_tensor(np.array(a))


def to_torch(f):
    a = np.asarray
    return fused_from_numpy(a(f.dense), a(f.learned.idx), a(f.learned.val),
                            a(f.lexical.idx), a(f.lexical.val), "cpu")


def rows_equal_as_sets(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.mean([set(x[x >= 0].tolist()) == set(y[y >= 0].tolist())
                          for x, y in zip(a, b)]))


def repro_rounds(key, n: int, cfg: RKnnConfig):
    """The init graph and round tables repro's build_knn_graph draws from
    ``key`` (knn_graph.py:129-152)."""
    key, k0 = jax.random.split(key)
    init = rknn._init_graph(n, cfg.k, k0)
    rounds = []
    for _ in range(cfg.iters):
        key, kr = jax.random.split(key)
        rounds.append(t(jax.random.randint(kr, (n, cfg.extra_random), 0, n, dtype=jnp.int32)))
    return init, rounds


@pytest.fixture(scope="module")
def ref():
    c = r_make_corpus(RCorpusConfig(n_docs=N, n_queries=8, n_topics=12, d_dense=32,
                                    nnz_sparse=16, nnz_lexical=8, seed=1))
    return jax.tree.map(jnp.asarray, c.docs), to_torch(c.docs)


def test_core_exports_match_repro():
    import repro_torch.core as tcore

    assert tcore.__all__ == rcore.__all__
    for name in tcore.__all__:  # a class for a class, a function for a (jitted) function
        got, want = getattr(tcore, name), getattr(rcore, name)
        assert isinstance(got, type) == isinstance(want, type), name
        assert callable(got) == callable(want), name
    from repro_torch.core import search
    from repro_torch.core.search import search as search_fn

    assert search is search_fn and callable(search)  # the function, not the submodule
    assert tcore.build_knn_graph is tknn.build_knn_graph
    assert tcore.rng_ip_prune is tpr.rng_ip_prune
    with pytest.raises(AttributeError):
        tcore.no_such_name  # noqa: B018


@pytest.mark.parametrize("weighted", [False, True], ids=["fused", "dense_path"])
def test_build_knn_graph_matches_repro(ref, weighted):
    """From the same init_ids (repro's random init graph) and round draws;
    the dense-path variant scores with the weight-scaled queries and starts
    from the fused graph, as repro's legacy per-path refinement does."""
    docs, tdocs = ref
    key = jax.random.key(0)
    rcfg = RKnnConfig(use_kernel=False, **KNN)
    init, rounds = repro_rounds(key, N, rcfg)
    rq = tq = None
    if weighted:
        init, _ = rknn.build_knn_graph(docs, rcfg, jax.random.key(9))
        w = RPathWeights.make(1.0, 0.0, 0.0)
        rq = rusms.weighted_query(docs, w)
        tq = tusms.weighted_query(tdocs, tusms.PathWeights.make(1.0, 0.0, 0.0))
    want_ids, want_sc = rknn.build_knn_graph(docs, rcfg, key, queries=rq, init_ids=init)
    got_ids, got_sc = tknn.build_knn_graph(tdocs, KnnConfig(**KNN), torch.Generator(),
                                           queries=tq, init_ids=t(init), rounds=rounds)
    assert got_ids.dtype == torch.int32 and got_ids.shape == (N, KNN["k"])
    assert rows_equal_as_sets(got_ids, want_ids) >= 0.99
    np.testing.assert_allclose(got_sc.numpy(), np.asarray(want_sc), rtol=1e-5, atol=1e-5)


def test_build_knn_graph_own_draws(ref):
    """Its own draws, a narrow warm start widened by random ids: a
    well-formed, score-sorted graph whose recall against brute force beats
    the random start's."""
    _, tdocs = ref
    cfg = KnnConfig(**KNN)
    gen = torch.Generator().manual_seed(3)
    start = tknn._init_graph(N, 4, gen, "cpu")
    ids, sc = tknn.build_knn_graph(tdocs, cfg, gen, init_ids=start)
    assert ids.shape == (N, cfg.k) and ((ids >= 0) & (ids < N)).all()
    assert not (ids == torch.arange(N)[:, None]).any()
    assert bool((sc[:, :-1] >= sc[:, 1:]).all())
    ip = tdocs.dense @ tdocs.dense.T  # the dense path alone, as a recall yardstick
    truth = torch.sort(ip.fill_diagonal_(-1e9), dim=1, descending=True, stable=True)[1][:, :8]
    assert tknn.knn_recall(ids, truth) > tknn.knn_recall(start, truth)


def test_knn_recall_matches_repro():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 50, size=(30, 8)).astype(np.int32)
    b = np.stack([rng.permutation(50)[:6] for _ in range(30)]).astype(np.int32)
    assert tknn.knn_recall(t(a), t(b)) == rknn.knn_recall(jnp.asarray(a), jnp.asarray(b))
    assert tknn.knn_recall(t(b[:, ::-1].copy()), b) == 1.0


@pytest.mark.parametrize("with_paths", [False, True])
def test_rng_ip_prune_matches_repro(ref, with_paths):
    """On repro's kNN graph (and its per-path picks): the same edges."""
    docs, tdocs = ref
    key = jax.random.key(0)
    knn_ids, knn_sc = rknn.build_knn_graph(docs, RKnnConfig(use_kernel=False, **KNN), key)
    path_ids = None
    if with_paths:
        path_ids = jnp.stack([rknn.build_knn_graph(
            docs, RKnnConfig(use_kernel=False, k=12, iters=1, node_chunk=256),
            jax.random.fold_in(key, i + 1), queries=rusms.weighted_query(docs, w),
            init_ids=knn_ids)[0][:, :3]
            for i, w in enumerate((RPathWeights.make(1.0, 0.0, 0.0),
                                   RPathWeights.make(0.0, 1.0, 0.0),
                                   RPathWeights.make(0.0, 0.0, 1.0)))], axis=1)
    want_sem, want_kw = rpr.rng_ip_prune(docs, knn_ids, knn_sc,
                                         RPruneConfig(use_kernel=False, **PRUNE),
                                         path_ids=path_ids)
    got_sem, got_kw = tpr.rng_ip_prune(tdocs, t(knn_ids), t(knn_sc), PruneConfig(**PRUNE),
                                       path_ids=None if path_ids is None else t(path_ids))
    assert got_sem.shape == (N, PRUNE["degree"])
    np.testing.assert_array_equal(got_sem.numpy(), np.asarray(want_sem))
    assert rows_equal_as_sets(got_kw, want_kw) == 1.0


def test_sparse_helpers_match_repro():
    """Top-nnz by magnitude with planted ties (to the lowest index) and
    all-zero rows (PAD slots); back to dense with duplicates summed; the
    concatenated oracle vector."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 40)).astype(np.float32)
    x[0, 0, [3, 7, 11]] = 5.0  # a three-way tie at the top
    x[0, 1, [2, 9]] = -4.0
    x[1, 2] = 0.0
    x[1, 3, 6:] = 0.0  # fewer nonzeros than the cap
    for cap in (4, 8):
        want = rusms.sparse_from_dense(jnp.asarray(x), cap)
        got = tusms.sparse_from_dense(t(x), cap)
        assert got.idx.dtype == torch.int32
        np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
        np.testing.assert_array_equal(got.val.numpy(), np.asarray(want.val))
        np.testing.assert_array_equal(tusms.sparse_to_dense(got, 40).numpy(),
                                      np.asarray(rusms.sparse_to_dense(want, 40)))
    idx = np.array([[3, 3, -1, 0], [5, 1, 2, -1]], np.int32)  # a duplicate id sums
    val = np.array([[1.0, 2.0, 0.0, 0.5], [1.0, 1.0, 1.0, 0.0]], np.float32)
    want = rusms.sparse_to_dense(rusms.SparseVec(jnp.asarray(idx), jnp.asarray(val)), 8)
    got = tusms.sparse_to_dense(tusms.SparseVec(t(idx), t(val)), 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    c = r_make_corpus(RCorpusConfig(n_docs=16, n_queries=2, n_topics=2, d_dense=8,
                                    nnz_sparse=6, nnz_lexical=4, seed=2))
    docs = jax.tree.map(jnp.asarray, c.docs)
    cfg = dataclasses.asdict(RCorpusConfig())
    want = rusms.concat_dense(docs, cfg["vocab_sparse"], cfg["vocab_lexical"])
    got = tusms.concat_dense(to_torch(c.docs), cfg["vocab_sparse"], cfg["vocab_lexical"])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
