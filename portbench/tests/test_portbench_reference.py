"""The plain reference against the port's plain search path.

On a tiny corpus with a search wide enough to visit every doc, the port's
weighted-sum answers are the reference's exact answers up to ties; in every
fusion mode, with keywords and tombstones, the reference recomputes the
path and fused scores of what the port returned to rounding, and finds no
id that breaks a guarantee. (RRF and zscore rank the search's final pool,
the reference the whole corpus, so only their scores are compared.)
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import judge, program
from portbench import reference as ref
from portbench.corpus import PAD, corpus_spec, make_corpus
from portbench.tests.conftest import SEED
from portbench import harness

SPECS = [
    {"mode": "weighted_sum", "weights": [1.0, 1.0, 1.0]},
    {"mode": "weighted_sum", "weights": [0.6, 0.3, 0.1]},
    {"mode": "zscore", "weights": [1.0, 1.0, 1.0]},
    {"mode": "rrf", "weights": [1.0, 1.0, 1.0], "rrf_k": 60.0},
]


@pytest.fixture(scope="module")
def built():
    from repro_torch.core.build_pipeline import build_index
    from repro_torch.core.index import BuildConfig, mark_deleted
    from repro_torch.core.knn_graph import KnnConfig
    from repro_torch.core.pruning import PruneConfig

    cfg = dict(harness.configuration("nq-hybrid-fp32"), n_docs=256, n_queries=16,
               n_topics=4, d_dense=32)
    corpus = make_corpus(corpus_spec(cfg), SEED, "cpu")
    bcfg = BuildConfig(knn=KnnConfig(k=16, iters=3, node_chunk=256),
                       prune=PruneConfig(degree=16, keyword_degree=8, node_chunk=128),
                       path_refine_iters=0)
    index = build_index(program.fused(corpus.docs), bcfg,
                        generator=torch.Generator().manual_seed(7), device="cpu")
    dead = np.random.default_rng(3).choice(256, 8, replace=False)
    index = mark_deleted(index, dead)
    return cfg, corpus, index


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s["mode"] + str(s["weights"][0]))
@pytest.mark.parametrize("keywords", [False, True], ids=["plain", "keywords"])
def test_reference_against_plain_search(built, spec, keywords, monkeypatch):
    from repro_torch.core.fusion import PathStats
    from repro_torch.core.search import SearchParams, search

    cfg, corpus, index = built
    n_q = corpus.queries.n
    fs = program.fusion_spec(spec)
    if spec["mode"] == "zscore":
        # stats given to both sides: the norms of unit dense rows spread by
        # ~1e-8, which leaves a zscore's dense term to the stats' rounding
        mean, std = [0.9, 1.0, 1.0], [0.05, 0.3, 0.3]
        t = lambda v: torch.tensor(v, dtype=torch.float32)
        fs.stats = PathStats(minv=t([0.0] * 3), maxv=t([2.0] * 3), mean=t(mean), std=t(std))
        monkeypatch.setattr(ref, "path_stats", lambda store, alive: ref.PathStats(
            torch.tensor(mean, dtype=torch.float64), torch.tensor(std, dtype=torch.float64)))
    kw = corpus.query_keywords if keywords else None
    params = SearchParams(iters=256, pool_size=256, use_keywords=keywords, use_kernel=False)
    res = search(index, program.fused(corpus.queries), fs, params, keywords=kw, device="cpu")
    answers = {"ids": res.ids.numpy(), "scores": res.scores.numpy(),
               "path_scores": res.path_scores.numpy(), "expanded": res.expanded.numpy()}
    key = corpus.query_keywords[:, 0].astype(np.int64) if keywords else None
    rows = ref.fusion_rows([spec], np.zeros(n_q, int), np.arange(n_q), key)
    checks, _, _ = judge.check(corpus, rows, answers, index.alive, cfg)
    assert checks["path_gap"] < 1e-5 and checks["score_gap"] < 1e-5, checks
    assert checks.get("zscore_gap", 0.0) < 1e-5, checks
    assert all(checks.get(k, 0) == 0 for k in ("bad_ids", "dead_returned", "keyword_missed",
                                               "order_faults", "unexpanded_rows")), checks
    if keywords:
        assert (key >= 0).any()
    if spec["mode"] == "weighted_sum":
        want = judge.truth(corpus, rows, index.alive, cfg)
        qi = torch.arange(n_q)
        store = ref.store_fp32(corpus.docs)
        w = torch.as_tensor(rows.weights)[:, None, :]
        got_s = (ref.path_scores(corpus.queries, store, qi, res.ids.long())[0] * w).sum(-1)
        want_s = (ref.path_scores(corpus.queries, store, qi, want)[0] * w).sum(-1)
        live = want >= 0
        assert torch.equal(res.ids >= 0, live)
        assert torch.allclose(got_s[live], want_s[live], rtol=0, atol=1e-5)


def test_rrf_truth_fuses_ranked_lists():
    """RRF over per-path lists: a doc first on every path wins, and the sum
    of a doc's contributions decides the rest."""
    ids = torch.tensor([[5, 2, 9]])
    sc = torch.tensor([[3.0, 2.0, 1.0]])
    lists = [[sc, ids], [sc, torch.tensor([[5, 9, 2]])], [sc, torch.tensor([[2, 5, 9]])]]
    w = torch.ones(1, 3, dtype=torch.float64)
    top = ref._rrf_top(lists, w, torch.tensor([60.0], dtype=torch.float64), 3)
    assert top.tolist() == [[5, 2, 9]]


def test_int8_store_is_the_seal_format():
    from repro_torch.core.usms import quantize_corpus

    cfg = dict(harness.configuration("msmarco-hybrid-int8"), n_docs=64, n_queries=4,
               n_topics=4, d_dense=32)
    corpus = make_corpus(corpus_spec(cfg), SEED, "cpu")
    mine = ref.store_int8(corpus.docs)
    port = quantize_corpus(program.fused(corpus.docs))
    assert torch.equal(mine.dense, port.dense_q)
    assert torch.equal(mine.scale, port.dense_scale)
    assert torch.equal(mine.learned_val, port.learned.val)
    assert (corpus.query_keywords[:, 1:] == PAD).all()


@pytest.mark.parametrize("spec", SPECS[:2], ids=lambda s: str(s["weights"]))
@pytest.mark.parametrize("keywords", [False, True], ids=["plain", "keywords"])
def test_round_selections_against_plain_search(built, spec, keywords):
    """Each round's fused top-k, caught as the port's plain search makes it
    (a pool narrower than a round's candidates, so the selection drops some),
    is the reference's top k of the same candidates."""
    from repro_torch.core.search import SearchParams, search

    cfg, corpus, index = built
    kw = corpus.query_keywords if keywords else None
    params = SearchParams(iters=16, pool_size=16, expand=2, use_keywords=keywords,
                          use_kernel=False)
    with program.kept_topk() as kept:
        search(index, program.fused(corpus.queries), program.fusion_spec(spec), params,
               keywords=kw, device="cpu")
    assert any(k < ids.shape[1] for ids, k, *_ in kept)
    got = judge.check_rounds(corpus, [(spec["weights"], kept)], cfg)
    assert got["topk_faults"] == 0 and got["topk_gap"] < 1e-5, got


def test_round_selection_tie_rule():
    """A doc offered twice ties with itself: the earlier position goes first
    and is the one kept."""
    cfg = dict(harness.configuration("nq-hybrid-fp32"), n_docs=64, n_queries=1,
               n_topics=4, d_dense=32)
    corpus = make_corpus(corpus_spec(cfg), SEED, "cpu")
    store = ref.store_fp32(corpus.docs)
    w = np.ones(3)
    one = torch.ones(3, dtype=torch.float64)
    every, _ = ref.candidate_scores(corpus.queries, store, torch.arange(64)[None], one)
    a, b = int(every.argmax()), int(every.argmin())
    ids = torch.tensor([[a, a, b, PAD]])
    top = ref.candidate_scores(corpus.queries, store, ids, one)[0].float()

    def check(k, pos):
        pos = torch.tensor([pos])
        call = (ids, k, None, torch.gather(top, 1, pos.clamp(min=0)), pos)
        return ref.check_topk([call], corpus.queries, store, w)

    faults = lambda k, pos: check(k, pos)["topk_faults"]

    assert faults(3, [0, 1, 2]) == 0 and faults(1, [0]) == 0
    assert faults(1, [1]) == 1  # kept over an equal candidate at a lower position
    assert faults(2, [1, 0]) == 1  # equal scores out of position order
    assert faults(2, [0, 2]) == 0 and check(2, [0, 2])["topk_gap"] > 0.01  # a weaker doc kept
    assert faults(2, [0, 3]) >= 1  # a PAD candidate kept
    assert faults(3, [0, -1, 1]) >= 1  # a slot after an empty one
