"""The port's text ingestion (``repro_torch.ingest``) and adaptive fusion
(``repro_torch.core.fusion.adaptive_fusion``) against repro's, on the same
texts: the analyzer's ids, the frozen corpus stats, the entity vocab and
triplets equal; every encoded array (docs and queries, on the bundled
corpus and a SynCorpus sample) equal bit for bit; a fitted pipeline saved
by either package loads into the other (and crosses through
``convert.ingest_pipeline_from_arrays``) with byte-equal manifests and
arrays; a build under repro's draws gives the same edges as row sets and
the same search ids up to ties; hybrid recall is no lower than dense-only;
``stream_into`` through a ``SegmentRouter`` keeps the sealed keys; the
adaptive selector equals repro's leaf for leaf on hypothesis-drawn
keyword, entity and nnz arrays, with stats and without."""

from __future__ import annotations

import dataclasses
import json
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small tensors: threads only contend with the other workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402
from hypothesis.extra import numpy as hnp  # noqa: E402

from repro.core import fusion as rfusion  # noqa: E402
from repro.core.search import SearchParams as RSearchParams  # noqa: E402
from repro.core.search import search as r_search  # noqa: E402
from repro.data.syncorpus import SynCorpus, SynCorpusConfig  # noqa: E402
from repro.data.textcorpus import load_bundled_corpus, topic_truth  # noqa: E402
from repro.ingest import analyzer as ran  # noqa: E402
from repro.ingest import pipeline as rpipe  # noqa: E402
from repro_torch.convert import ingest_pipeline_from_arrays  # noqa: E402
from repro_torch.core import fusion as tfusion  # noqa: E402
from repro_torch.core.fusion import FusionSpec  # noqa: E402
from repro_torch.core.search import SearchParams, search  # noqa: E402
from repro_torch.core.segment_pool import SegmentPool  # noqa: E402
from repro_torch.data.corpus import recall_at_k  # noqa: E402
from repro_torch.ingest import analyzer as tan  # noqa: E402
from repro_torch.ingest import pipeline as tpipe  # noqa: E402
from repro_torch.serving.batcher import BatcherConfig  # noqa: E402
from repro_torch.serving.hybrid_service import HybridSearchService, ServiceConfig  # noqa: E402
from repro_torch.serving.segment_router import RouterConfig, SegmentRouter  # noqa: E402
from tests.test_torch_build import R_CFG, T_CFG, repro_draws, rows_equal_as_sets  # noqa: E402

PARAMS = dict(k=10, iters=48, pool_size=64)
ANALYZERS = {
    "default": {},
    "ngrams": dict(char_ngrams=3, vocab_size=4096, lexical_vocab_size=1024),
    "stopwords": dict(use_stopwords=False, extra_stopwords=("report", "percent"),
                      lowercase=False, min_token_len=3),
}


def host(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def fused_leaves(f):
    return [f.dense, f.learned.idx, f.learned.val, f.lexical.idx, f.lexical.val]


def assert_fused_equal(got, want):
    for g, w in zip(fused_leaves(got), fused_leaves(want)):
        g, w = host(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def fit_pair(texts, **cfg):
    """(repro pipeline, port pipeline, repro fit, port fit) on ``texts``."""
    a = cfg.pop("analyzer", {})
    r = rpipe.IngestPipeline(rpipe.IngestConfig(analyzer=ran.AnalyzerConfig(**a), **cfg))
    t = tpipe.IngestPipeline(tpipe.IngestConfig(analyzer=tan.AnalyzerConfig(**a), **cfg),
                             device="cpu")
    return r, t, r.fit(texts), t.fit(texts)


@pytest.fixture(scope="module")
def bundled():
    corpus = load_bundled_corpus()
    return (corpus,) + fit_pair(corpus.texts, d_dense=64)


@pytest.fixture(scope="module")
def syn():
    gen = SynCorpus(SynCorpusConfig(n_docs=2048, n_queries=32, seed=0))
    return (gen,) + fit_pair(gen.fit_sample(256), d_dense=128)


# -- analyzer ---------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(ANALYZERS))
def test_analyzer_ids_equal_repro(bundled, name):
    corpus = bundled[0]
    rc, tc = ran.AnalyzerConfig(**ANALYZERS[name]), tan.AnalyzerConfig(**ANALYZERS[name])
    texts = corpus.texts[:40] + corpus.query_texts + ['a "quoted phrase" and "Another One"']
    for text in texts:
        toks = tan.tokenize(text, tc)
        assert toks == ran.tokenize(text, rc)
        assert tan.raw_tokens(text) == ran.raw_tokens(text)
        assert tan.quoted_phrases(text) == ran.quoted_phrases(text)
        for fn in ("learned_id", "lexical_id"):
            assert (tan.term_counts(toks, getattr(tan, fn), tc)
                    == ran.term_counts(toks, getattr(ran, fn), rc))
    assert [tan.fnv1a(s) for s in ("", "rocket", "été")] == \
        [ran.fnv1a(s) for s in ("", "rocket", "été")]


@pytest.mark.parametrize("which", ["bundled", "syn"])
def test_stats_vocab_triplets_equal_repro(bundled, syn, which):
    _, r, t, rf, tf = bundled if which == "bundled" else syn
    assert (t.stats.n_docs, t.stats.avg_dl) == (r.stats.n_docs, r.stats.avg_dl)
    np.testing.assert_array_equal(t.stats.df_learned, r.stats.df_learned)
    np.testing.assert_array_equal(t.stats.df_lexical, r.stats.df_lexical)
    assert t.entity_vocab.names == r.entity_vocab.names
    assert t.n_triplets == r.n_triplets > 0
    np.testing.assert_array_equal(tf.kg.triplets, rf.kg.triplets)
    assert tf.kg.n_entities == rf.kg.n_entities
    np.testing.assert_array_equal(tf.doc_entities, rf.doc_entities)
    np.testing.assert_array_equal(tf.doc_lengths, rf.doc_lengths)


# -- encoding, bit for bit ---------------------------------------------------


@pytest.mark.parametrize("which", ["bundled", "syn"])
def test_encode_docs_and_queries_equal_repro(bundled, syn, which):
    if which == "bundled":
        corpus, r, t, rf, tf = bundled
        docs, queries = corpus.texts, corpus.query_texts + ['"scurvy" and the voyage home']
    else:
        gen, r, t, rf, tf = syn
        docs = gen.texts(1000, 1200)
        queries = [q.text for q in gen.queries()]
    assert_fused_equal(tf.docs, rf.docs)
    (td, te), (rd, re_) = t.encode_docs(docs), r.encode_docs(docs)
    assert_fused_equal(td, rd)
    np.testing.assert_array_equal(te, re_)
    tq, rq = t.encode_queries(queries), r.encode_queries(queries)
    assert_fused_equal(tq.vectors, rq.vectors)
    np.testing.assert_array_equal(tq.keywords, rq.keywords)
    np.testing.assert_array_equal(tq.entities, rq.entities)
    assert (tq.keywords >= 0).any() and (tq.entities >= 0).any()


def test_precomputed_dense_vectors_pass_through(bundled):
    corpus, r, t, _, _ = bundled
    dense = np.random.default_rng(0).standard_normal((4, 64)).astype(np.float32)
    (td, _), (rd, _) = (t.encode_docs(corpus.texts[:4], dense_vectors=dense),
                        r.encode_docs(corpus.texts[:4], dense_vectors=dense))
    assert_fused_equal(td, rd)
    np.testing.assert_array_equal(host(td.dense), dense)
    with pytest.raises(ValueError, match="dense_vectors"):
        t.encode_docs(corpus.texts[:4], dense_vectors=dense[:, :8])


def test_encode_requires_fit_and_device():
    pipe = tpipe.IngestPipeline(device="cpu")
    with pytest.raises(tpipe.NotFittedError):
        pipe.encode_docs(["text"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tpipe.IngestPipeline()  # the card unless the CPU is asked for
    with pytest.raises(RuntimeError, match="already fitted"):
        fitted = tpipe.IngestPipeline(device="cpu")
        fitted.fit(["Alpha Beta met Gamma Delta.", "Alpha Beta again."])
        fitted.fit(["more"])


# -- persistence, both ways ---------------------------------------------------


def npz_members(path) -> dict:
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in sorted(z.namelist())}


def test_save_load_cross_both_ways(bundled, tmp_path):
    corpus, r, t, _, _ = bundled
    r.save(tmp_path / "r")
    t.save(tmp_path / "t")
    man = rpipe.IngestPipeline.MANIFEST
    assert (tmp_path / "t" / man).read_bytes() == (tmp_path / "r" / man).read_bytes()
    arrs = rpipe.IngestPipeline.ARRAYS
    assert npz_members(tmp_path / "t" / arrs) == npz_members(tmp_path / "r" / arrs)
    t_from_r = tpipe.IngestPipeline.load(tmp_path / "r", device="cpu")
    r_from_t = rpipe.IngestPipeline.load(tmp_path / "t")
    via_convert = ingest_pipeline_from_arrays(r, "cpu")
    q = corpus.query_texts[:8] + ['"rye" sourdough starter']
    want = r.encode_queries(q)
    for got in (t_from_r.encode_queries(q), via_convert.encode_queries(q)):
        assert_fused_equal(got.vectors, want.vectors)
        np.testing.assert_array_equal(got.keywords, want.keywords)
        np.testing.assert_array_equal(got.entities, want.entities)
    back = r_from_t.encode_queries(q)
    assert_fused_equal(t.encode_queries(q).vectors, back.vectors)
    assert dataclasses.asdict(t_from_r.config) == dataclasses.asdict(r.config)
    # a second save renames the first aside and cleans it up
    t.save(tmp_path / "t")
    assert not list(tmp_path.glob(".old_t_*")) and not list(tmp_path.glob(".tmp_ingest_*"))


# -- build and search --------------------------------------------------------


@pytest.fixture(scope="module")
def built(bundled):
    """repro's build of the bundled corpus and the port's under repro's draws."""
    corpus, r, t, rf, tf = bundled
    key = jax.random.key(3)
    r_index = r.build(rf, R_CFG, key=key)
    t_index = t.build(tf, T_CFG, draws=repro_draws(tf.n_docs, R_CFG, key))
    return r_index, t_index


def test_build_equals_repro_under_its_draws(built):
    r_index, t_index = built
    for f in ("semantic_edges", "keyword_edges", "doc_entities", "entity_to_docs"):
        assert rows_equal_as_sets(host(getattr(t_index, f)),
                                  np.asarray(getattr(r_index, f))) >= 0.99, f
    np.testing.assert_array_equal(host(t_index.entity_adj), np.asarray(r_index.entity_adj))


@pytest.mark.parametrize("spec", ["dense", "three_path", "rrf"])
def test_search_equals_repro_up_to_ties(bundled, built, spec):
    corpus, r, t, _, _ = bundled
    r_index, t_index = built
    specs = {"dense": (FusionSpec.weighted(1, 0, 0), rfusion.FusionSpec.weighted(1, 0, 0)),
             "three_path": (FusionSpec.three_path(), rfusion.FusionSpec.three_path()),
             "rrf": (FusionSpec.rrf(), rfusion.FusionSpec.rrf())}[spec]
    tq, rq = t.encode_queries(corpus.query_texts), r.encode_queries(corpus.query_texts)
    got = search(t_index, tq.vectors, specs[0], SearchParams(**PARAMS), device="cpu")
    want = r_search(r_index, rq.vectors, specs[1], RSearchParams(use_kernel=False, **PARAMS))
    gi, wi = host(got.ids), np.asarray(want.ids)
    assert (gi == wi).mean() >= 0.95
    same = gi == wi
    np.testing.assert_allclose(host(got.scores)[same], np.asarray(want.scores)[same],
                               rtol=1e-4, atol=1e-4)


def test_hybrid_recall_no_lower_than_dense(bundled, built):
    corpus, _, t, _, _ = bundled
    _, t_index = built
    enc = t.encode_queries(corpus.query_texts)
    truth = torch.as_tensor(topic_truth(corpus.query_topics, corpus.topics))
    rec = {name: recall_at_k(search(t_index, enc.vectors, spec, SearchParams(**PARAMS),
                                    device="cpu").ids, truth)
           for name, spec in (("dense", FusionSpec.weighted(1, 0, 0)),
                              ("hybrid", FusionSpec.three_path()))}
    assert rec["hybrid"] >= rec["dense"]
    assert rec["hybrid"] >= 0.25  # the reference test's floor on this corpus


def test_query_keywords_constrain_results(bundled, built):
    _, _, t, _, tf = bundled
    _, t_index = built
    enc = t.encode_queries(['the voyage home "scurvy"'])
    assert (enc.keywords[0] >= 0).sum() == 1
    res = search(t_index, enc.vectors, FusionSpec.three_path(),
                 SearchParams(use_keywords=True, **PARAMS), keywords=enc.keywords, device="cpu")
    lex = host(tf.docs.lexical.idx)
    for doc in host(res.ids)[0]:
        if doc >= 0:
            assert int(enc.keywords[0, 0]) in lex[doc]


def test_build_sharded_without_and_with_mesh(bundled):
    _, _, t, _, tf = bundled
    seg = t.build_sharded(tf, 2, T_CFG)
    assert seg.n_segments == 2
    assert sorted(int(g) for g in host(seg.global_ids).ravel() if g >= 0) == list(range(120))
    # the mesh build itself runs on CPU ranks in test_torch_distributed.py;
    # here: it draws from a seed, never a generator
    with pytest.raises(ValueError, match="seed, not a generator"):
        t.build_sharded(tf, 2, T_CFG, mesh=object(), generator=torch.Generator())


def test_stream_into_router_keeps_sealed_keys(bundled):
    """New raw documents stream through the frozen pipeline into the grow
    segment: the stats do not move, no sealed key is dropped, and a
    streamed doc is retrievable by its own text under its new id."""
    corpus = bundled[0]
    texts = corpus.texts
    n0 = 100
    pipe = tpipe.IngestPipeline(tpipe.IngestConfig(d_dense=64), device="cpu")
    ing = pipe.fit(texts[:n0])
    pool = SegmentPool.from_segmented(pipe.build_sharded(ing, 1, T_CFG))
    svc = HybridSearchService(pool, SearchParams(**PARAMS), ServiceConfig(
        batcher=BatcherConfig(flush_size=4, max_batch=4, flush_deadline_s=60.0)))
    SegmentRouter(svc, T_CFG, RouterConfig(seal_threshold=10**9),
                  kg_triplets=ing.kg.triplets, n_entities=ing.kg.n_entities)
    q = pipe.encode_queries([s[:80] for s in texts[:4]])
    svc.search(q.vectors, FusionSpec.three_path(), k=5)
    sealed = set(svc.executable_cache)
    assert sealed
    df = pipe.stats.df_lexical.copy()
    v = pipe.stream_into(svc, texts[n0:])
    assert v >= 1 and svc.grow_index is not None
    np.testing.assert_array_equal(df, pipe.stats.df_lexical)
    enc = pipe.encode_queries([texts[n0 + 5]])
    res = svc.search(enc.vectors, FusionSpec.three_path(), k=5)
    assert n0 + 5 in host(res.ids)[0]
    assert sealed <= set(svc.executable_cache)


# -- adaptive fusion ---------------------------------------------------------


def spec_leaves(spec) -> dict:
    out = {"mode": spec.mode, "rrf_k": spec.rrf_k}
    out.update({f"w.{f}": getattr(spec.weights, f) for f in ("dense", "sparse", "full", "kg")})
    if spec.stats is not None:
        out.update({f"s.{f}": getattr(spec.stats, f) for f in ("minv", "maxv", "mean", "std")})
    return {k: host(v) for k, v in out.items()}


ids_arrays = st.integers(1, 6).flatmap(lambda b: st.tuples(
    hnp.arrays(np.int32, (b, 4), elements=st.integers(-1, 50)),
    hnp.arrays(np.int32, (b, 2), elements=st.integers(-1, 9)),
    hnp.arrays(np.int64, (b,), elements=st.integers(0, 16))))


@settings(max_examples=40, deadline=None)
@given(arrays=ids_arrays, with_stats=st.booleans(), rrf_k=st.sampled_from([60.0, 10.0]))
def test_adaptive_fusion_equals_repro(arrays, with_stats, rrf_k):
    kw, en, nnz = arrays
    stats = None
    if with_stats:
        vals = np.random.default_rng(int(nnz.sum())).random((4, 3)).astype(np.float32)
        stats = (tfusion.PathStats(*(torch.as_tensor(v) for v in vals)),
                 rfusion.PathStats(*(jnp.asarray(v) for v in vals)))
    got = tfusion.adaptive_fusion(kw, en, nnz, stats=stats and stats[0], rrf_k=rrf_k)
    want = rfusion.adaptive_fusion(kw, en, nnz, stats=stats and stats[1], rrf_k=rrf_k)
    g, w = spec_leaves(got), spec_leaves(want)
    assert g.keys() == w.keys()
    for k in g:
        assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_adaptive_fusion_for_equals_repro(syn):
    gen, r, t, _, _ = syn
    texts = [q.text for q in gen.queries()] + ['"a" "b" plain', "x " * 20]
    tq, rq = t.encode_queries(texts), r.encode_queries(texts)
    np.testing.assert_array_equal(tfusion.query_nnz(tq.vectors), rfusion.query_nnz(rq.vectors))
    g = spec_leaves(tpipe.adaptive_fusion_for(tq))
    w = spec_leaves(rpipe.adaptive_fusion_for(rq))
    for k in g:
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert len(np.unique(g["mode"])) >= 2
    json.dumps({k: v.tolist() for k, v in g.items()})  # host leaves, plain values
