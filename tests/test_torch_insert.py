"""The port's insert (``repro_torch.core.build_pipeline.insert``) and
``knn_graph.new_node_reverse`` against repro's, on a repro-built index
converted with ``convert.py`` and the same new docs, under repro's draws for
the NN-Descent among the new nodes. Edges are held as row sets in >= 99% of
rows, as the whole-build test holds them; self scores to 1e-5; alive, entity
and logical rows exactly. The back-link pass is held bit for bit on planted
collisions: two new nodes back-linking one old node (the last in row order
wins) and invalid targets clipped onto rows 0 and n_old - 1, which write
their old value back over a real back-link (a reference fault, ROADMAP
Queue 3, reproduced for parity)."""

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
from repro.core.index import BuildConfig as RBuildConfig  # noqa: E402
from repro.core.knn_graph import KnnConfig as RKnnConfig  # noqa: E402
from repro.core.pruning import PruneConfig as RPruneConfig  # noqa: E402
from repro.core.search import SearchParams as RSearchParams  # noqa: E402
from repro.data.corpus import CorpusConfig, make_corpus  # noqa: E402
from repro_torch.convert import index_from_arrays  # noqa: E402
from repro_torch.core import build_pipeline as tbp  # noqa: E402
from repro_torch.core import knn_graph as tknn  # noqa: E402
from repro_torch.core.index import BuildConfig  # noqa: E402
from repro_torch.core.knn_graph import KnnConfig  # noqa: E402
from repro_torch.core.pruning import PruneConfig  # noqa: E402
from repro_torch.core.search import SearchParams  # noqa: E402
from repro_torch.runtime import dispatch  # noqa: E402
from tests.test_torch_build import rows_equal_as_sets, t, to_torch  # noqa: E402

KNN = dict(k=8, iters=2, node_chunk=128)
PRUNE = dict(degree=8, keyword_degree=3, node_chunk=64)
R_CFG = RBuildConfig(knn=RKnnConfig(use_kernel=False, **KNN),
                     prune=RPruneConfig(use_kernel=False, **PRUNE), path_refine_iters=0)
T_CFG = BuildConfig(knn=KnnConfig(**KNN), prune=PruneConfig(**PRUNE), path_refine_iters=0)
N_OLD, N_NEW = 256, 64


def descent_draws(n: int, knn, key) -> tbp.BuildDraws:
    """The init graph and round tables repro's nn_descent draws from ``key``
    (build_pipeline.py:136-188): enough for a build without refinement and
    for an insert's descent among the new nodes."""
    key_r, k0 = jax.random.split(key)
    init = rknn._init_graph(n, knn.k, k0)
    rounds = []
    for _ in range(knn.iters):
        key_r, kr = jax.random.split(key_r)
        rounds.append(t(jax.random.randint(kr, (n, knn.extra_random), 0, n, dtype=jnp.int32)))
    return tbp.BuildDraws(init_graph=t(init), rounds=rounds)


def host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def base():
    c = make_corpus(CorpusConfig(n_docs=N_OLD + N_NEW, n_queries=8, n_topics=8, d_dense=16,
                                 nnz_sparse=8, nnz_lexical=6, seed=19))
    docs = jax.tree.map(jnp.asarray, c.docs)
    index = rbp.build_index(docs[:N_OLD], R_CFG, key=jax.random.key(3),
                            kg_triplets=c.kg.triplets, doc_entities=c.doc_entities[:N_OLD],
                            n_entities=c.kg.n_entities)
    return c, docs, index, index_from_arrays(index, "cpu")


def assert_index_matches(got, want, edges=0.99):
    for f in ("semantic_edges", "keyword_edges"):
        g, w = host(getattr(got, f)), host(getattr(want, f))
        assert g.shape == w.shape
        assert rows_equal_as_sets(g, w) >= edges, f
    for f in ("alive", "doc_entities", "logical_edges", "entity_to_docs", "entity_adj",
              "entry_points"):
        np.testing.assert_array_equal(host(getattr(got, f)), host(getattr(want, f)))
    np.testing.assert_allclose(host(got.self_ip), host(want.self_ip), atol=1e-5)
    np.testing.assert_array_equal(host(got.corpus.dense), host(want.corpus.dense))


def test_new_node_reverse_matches_repro():
    rng = np.random.default_rng(5)
    n_old, n_new, k = 40, 12, 6
    # global ids: old ids below n_new too, new ids, PAD
    merged = rng.integers(-1, n_old + n_new, size=(n_new, k)).astype(np.int32)
    merged[:, 0] = rng.integers(0, n_new, size=n_new)  # old ids < n_new
    for cap in (1, 3):
        want = np.asarray(rknn.new_node_reverse(jnp.asarray(merged), n_old, cap))
        got = tknn.new_node_reverse(torch.as_tensor(merged), n_old, cap).numpy()
        np.testing.assert_array_equal(got, want)
        assert ((got == -1) | (got >= n_old)).all()


@pytest.mark.parametrize("entities", [True, False])
def test_insert_matches_repro(base, entities):
    c, docs, r_index, t_index = base
    key = jax.random.key(11)
    new = docs[N_OLD:]
    ents = c.doc_entities[N_OLD:] if entities else None
    want = rbp.insert(r_index, new, R_CFG, key=key, new_doc_entities=ents)
    rows0, calls0 = dispatch.build_rows(), dispatch.count()
    got = tbp.insert(t_index, to_torch(c.docs[N_OLD:]), T_CFG,
                     draws=descent_draws(N_NEW, R_CFG.knn, key), new_doc_entities=ents)
    # repro's call sites: the probe, the two of nn_descent, the fused program
    assert dispatch.build_rows() - rows0 == N_NEW and dispatch.count() - calls0 == 4
    assert got.n == want.n == N_OLD + N_NEW
    assert_index_matches(got, want)
    # copy-on-write: the published index is never written
    np.testing.assert_array_equal(t_index.semantic_edges.numpy(),
                                  np.asarray(r_index.semantic_edges))
    assert t_index.n == N_OLD


def test_insert_with_small_probe_matches_repro(base):
    c, docs, r_index, t_index = base
    key = jax.random.key(12)
    small = dict(k=4, iters=8, pool_size=8)  # k and pool forced up to 8 / 16
    want = rbp.insert(r_index, docs[N_OLD:N_OLD + 32], R_CFG, key=key,
                      search_params=RSearchParams(use_kernel=False, **small))
    got = tbp.insert(t_index, to_torch(c.docs[N_OLD:N_OLD + 32]), T_CFG,
                     draws=descent_draws(32, R_CFG.knn, key),
                     search_params=SearchParams(**small))
    assert_index_matches(got, want)
    with pytest.raises(ValueError, match="entity width"):
        tbp.insert(t_index, to_torch(c.docs[N_OLD:N_OLD + 4]), T_CFG,
                   new_doc_entities=np.zeros((4, 99), np.int32))


def test_back_link_collisions_match_repro(base):
    """Planted merged lists through both packages' fused insert program: rows
    0-1 of the new nodes back-link old node 5 at the same rank (the last in
    row order wins); new node 2 back-links old node 0 and new node 3 has no
    valid candidate, so its PAD target clips onto row 0 and writes the old
    value back over node 2's back-link; new node 4 back-links n_old - 1 and
    new node 5's first candidate is a new node, clipped onto n_old - 1."""
    c, docs, r_index, t_index = base
    n_new, k = 8, KNN["k"]
    big, lo = 10.0, -1.0
    old_ids = np.full((n_new, k), -1, np.int32)
    old_sc = np.full((n_new, k), -np.inf, np.float32)
    new_ids = np.full((n_new, k), -1, np.int32)
    new_sc = np.full((n_new, k), -np.inf, np.float32)
    plants = {0: [5, 9, 17, 30], 1: [5, 11, 17, 31], 2: [0, 12, 18, 32],
              4: [N_OLD - 1, 13, 19, 33], 6: [40, 41, 42, 43], 7: [44, 45, 46, 47]}
    for r, targets in plants.items():
        old_ids[r, :4] = targets
        old_sc[r, :4] = big - np.arange(4)
    new_ids[5, 0], new_sc[5, 0] = 6, big  # a new node ranks first: clipped onto n_old - 1
    old_ids[5, :3], old_sc[5, :3] = [50, 51, 52], lo
    # row 3: nothing valid at all -> PAD target, clipped onto row 0
    new_docs = docs[N_OLD:N_OLD + n_new]
    corpus = jax.tree.map(lambda a, b: jnp.concatenate([a, b]), r_index.corpus, new_docs)
    r_out = rbp._insert_program(corpus, new_docs, r_index.self_ip, r_index.semantic_edges,
                                jnp.asarray(old_ids), jnp.asarray(old_sc),
                                jnp.asarray(new_ids), jnp.asarray(new_sc), R_CFG)
    t_docs = to_torch(c.docs[N_OLD:N_OLD + n_new])
    t_corpus = tbp.cat_fused([t_index.corpus, t_docs])
    t_out = tbp._insert_program(t_corpus, t_docs, t_index.self_ip, t_index.semantic_edges,
                                t(old_ids), t(old_sc), t(new_ids), t(new_sc), T_CFG)
    sem_r, sem_t = np.asarray(r_out[0]), t_out[0].numpy()
    np.testing.assert_array_equal(sem_t, sem_r)
    d = sem_r.shape[1]
    before = np.asarray(r_index.semantic_edges)
    assert sem_r[5, d - 1] == N_OLD + 1  # duplicate target: the later row wins
    assert sem_r[0, d - 1] == before[0, d - 1]  # node 2's back-link clobbered by node 3's PAD
    assert sem_r[N_OLD - 1, d - 1] == before[N_OLD - 1, d - 1]  # ... and by node 5's new id
    assert sem_r[40, d - 1] == N_OLD + 6  # an uncontested back-link lands
    for a, b in zip(t_out[1:], r_out[1:]):
        np.testing.assert_allclose(host(a), np.asarray(b), atol=1e-5)


def test_insert_program_is_copy_on_write(base):
    _, _, _, t_index = base
    sem = t_index.semantic_edges.clone()
    merged = torch.full((2, KNN["k"]), -1, dtype=torch.int32)
    merged[:, 0] = torch.tensor([3, 3])
    out = tbp._back_link(t_index.semantic_edges, merged, N_OLD, KNN["k"])
    assert torch.equal(t_index.semantic_edges, sem)
    assert out[3, -1] == N_OLD + 1 and out.data_ptr() != sem.data_ptr()


def test_insert_then_search_finds_new_docs(base):
    """Each inserted doc, queried with its own vector under dense-only
    weights, comes back first from the grown index about as often as from
    repro's grown under the same draws."""
    c, docs, r_index, t_index = base
    from repro.core.fusion import FusionSpec as RFusionSpec
    from repro.core.search import search as r_search
    from repro_torch.core.fusion import FusionSpec
    from repro_torch.core.search import search

    key = jax.random.key(2)
    want = np.arange(N_OLD, N_OLD + N_NEW)
    r_grown = rbp.insert(r_index, docs[N_OLD:], R_CFG, key=key)
    r_res = r_search(r_grown, docs[N_OLD:], RFusionSpec.make("weighted_sum", 1.0, 0.0, 0.0),
                     RSearchParams(k=4, iters=48, use_kernel=False))
    grown = tbp.insert(t_index, to_torch(c.docs[N_OLD:]), T_CFG,
                       draws=descent_draws(N_NEW, R_CFG.knn, key))
    res = search(grown, to_torch(c.docs[N_OLD:]), FusionSpec.make("weighted_sum", 1.0, 0.0, 0.0),
                 SearchParams(k=4, iters=48), device="cpu")
    hits = (res.ids[:, 0].numpy() == want).mean()
    r_hits = (np.asarray(r_res.ids)[:, 0] == want).mean()
    assert hits >= 0.9 and abs(hits - r_hits) <= 2 / N_NEW, (hits, r_hits)
