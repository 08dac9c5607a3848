"""Spans and counters inside the port's core: the active tracing context of
``repro_torch.obs``, the search round spans and counters, the build stage
spans, their clock against ``torch.profiler``'s, and the core spans of a
traced service batch. Imports neither jax nor repro."""

from __future__ import annotations

import contextlib
import importlib
import math
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small tensors: threads only contend with the other workers

from repro_torch import obs  # noqa: E402
from repro_torch.core.build_pipeline import build_index  # noqa: E402
from repro_torch.core.fusion import FusionSpec  # noqa: E402
from repro_torch.core.index import BuildConfig  # noqa: E402
from repro_torch.core.knn_graph import KnnConfig  # noqa: E402
from repro_torch.core.pruning import PruneConfig  # noqa: E402
from repro_torch.core.search import SearchParams, search  # noqa: E402
from repro_torch.core.segment_pool import build_pool_segment  # noqa: E402
from repro_torch.data.corpus import CorpusConfig, make_corpus  # noqa: E402
from repro_torch.obs import tracer  # noqa: E402
from repro_torch.obs.tracer import TraceContext  # noqa: E402
from repro_torch.serving.batcher import BatcherConfig, SearchRequest  # noqa: E402
from repro_torch.serving.hybrid_service import HybridSearchService, ServiceConfig  # noqa: E402

search_mod = importlib.import_module("repro_torch.core.search")  # the module, not the function
BUILD = BuildConfig(knn=KnnConfig(k=12, iters=2, node_chunk=64),
                    prune=PruneConfig(degree=12, keyword_degree=4, node_chunk=48),
                    path_refine_iters=1)
N_DOCS = 200  # prune chunks of 48: five, the last one short


@pytest.fixture(scope="module")
def corpus():
    return make_corpus(CorpusConfig(n_docs=N_DOCS, n_queries=6, n_topics=8, d_dense=16,
                                    nnz_sparse=8, nnz_lexical=6, seed=5), device="cpu")


@pytest.fixture(scope="module")
def index(corpus):
    gen = torch.Generator().manual_seed(3)
    return build_index(corpus.docs, BUILD, generator=gen, device="cpu")


def _params(keywords: bool) -> SearchParams:
    return SearchParams(k=5, iters=6, pool_size=24, kw_pool_size=8, use_keywords=keywords)


def _search(corpus, index, keywords: bool):
    kw = corpus.query_keywords if keywords else None
    return search(index, corpus.queries, FusionSpec.three_path(), _params(keywords),
                  keywords=kw, device="cpu")


def _inside(child, parent) -> bool:
    return parent.t0 <= child.t0 and child.t1 <= parent.t1


def _assert_nested(span) -> None:
    for c in span.children:
        assert c.t1 is not None and _inside(c, span), (c, span)
        _assert_nested(c)


# ---------------------------------------------------------------------------
# the mechanism
# ---------------------------------------------------------------------------


def test_span_sites_are_inert_without_an_active_context():
    assert obs.active() is None
    first, second = obs.span("a", i=1), obs.span("b")
    assert first is second  # the one shared null context
    with first as s:
        assert s is None
    obs.count("c", torch.ones(()))  # dropped, never read


def test_spans_nest_under_the_innermost_open_span_and_counters_settle():
    ctx = TraceContext("call")
    with obs.tracing(ctx):
        assert obs.active() is ctx
        with obs.span("outer", x=1) as outer:
            with obs.span("inner"):
                obs.count("n", 2)
                obs.count("dev", torch.tensor(3))
            obs.count("dev", torch.tensor(4))
        with obs.span("second"):
            pass
        assert ctx.counters == {"n": 2}  # the device values wait for the end
    assert obs.active() is None
    assert [c.name for c in ctx.root.children] == ["outer", "second"]
    assert [c.name for c in outer.children] == ["inner"] and outer.attrs == {"x": 1}
    assert ctx.counters == {"n": 2, "dev": 7}
    u0, p0 = ctx.clock
    u1, p1 = ctx.clock_end
    assert p1 >= p0 and u1 >= u0
    with obs.tracing(None) as none:  # activates nothing
        assert none is None and obs.active() is None


def test_an_error_inside_a_span_is_recorded_and_the_scope_restored():
    ctx = TraceContext("call")
    with pytest.raises(RuntimeError):
        with obs.tracing(ctx), obs.span("fails"):
            raise RuntimeError("boom")
    assert obs.active() is None
    (span,) = ctx.find("fails")
    assert "boom" in span.attrs["error"] and span.t1 is not None


# ---------------------------------------------------------------------------
# search
# ---------------------------------------------------------------------------


class _Counts:
    """Host reads of device values and device syncs, counted by patching."""

    def __init__(self, monkeypatch):
        self.n = {}
        for name in ("item", "cpu", "tolist", "numpy"):
            self._wrap(monkeypatch, torch.Tensor, name)
        self._wrap(monkeypatch, torch.cuda, "synchronize")

    def _wrap(self, monkeypatch, owner, name):
        orig = getattr(owner, name)

        def counted(*a, **kw):
            self.n[name] = self.n.get(name, 0) + 1
            return orig(*a, **kw)

        monkeypatch.setattr(owner, name, counted)


class _NoObs:
    """A stand-in for ``obs`` with no instrumentation at all: the search as
    it ran before its span sites."""

    @staticmethod
    def span(name, **attrs):
        return contextlib.nullcontext()

    @staticmethod
    def active():
        return None

    @staticmethod
    def count(name, value):
        pass


@pytest.mark.parametrize("keywords", [False, True], ids=["plain", "keywords"])
def test_untraced_search_is_the_traced_search_without_spans_or_reads(
        corpus, index, keywords, monkeypatch):
    made = []

    class CountedSpan(tracer.Span):
        def __init__(self, *a, **kw):
            made.append(a[0])
            super().__init__(*a, **kw)

    with monkeypatch.context() as m:
        m.setattr(search_mod, "obs", _NoObs)
        bare_counts = _Counts(m)
        bare = _search(corpus, index, keywords)
    with monkeypatch.context() as m:
        m.setattr(tracer, "Span", CountedSpan)
        counts = _Counts(m)
        off = _search(corpus, index, keywords)
    assert made == [] and counts.n == bare_counts.n
    with monkeypatch.context() as m:
        traced_counts = _Counts(m)
        with obs.tracing(TraceContext("call")) as ctx:
            on = _search(corpus, index, keywords)
    assert len(ctx.find("search.round")) == _params(keywords).iters
    # tracing reads the device once: the fresh-candidate counter, at its end
    assert traced_counts.n.get("item", 0) == counts.n.get("item", 0) + 1
    for a, b, c in [(bare.ids, off.ids, on.ids), (bare.scores, off.scores, on.scores),
                    (bare.path_scores, off.path_scores, on.path_scores),
                    (bare.expanded, off.expanded, on.expanded)]:
        assert torch.equal(a, b) and torch.equal(b, c)


@pytest.mark.parametrize("keywords", [False, True], ids=["plain", "keywords"])
def test_traced_search_tree_and_counters(corpus, index, keywords):
    p = _params(keywords)
    with obs.tracing(TraceContext("call")) as ctx:
        _search(corpus, index, keywords)
    (root,) = ctx.root.children
    assert root.name == "search"
    assert root.attrs == dict(B=corpus.queries.n, iters=p.iters, pool=p.pool_size,
                              expand=p.expand, corpus_dtype="float32", mode="weighted_sum")
    names = [c.name for c in root.children]
    assert names == ["search.entry"] + ["search.round"] * p.iters + ["search.final"]
    rounds = root.children[1:-1]
    assert [r.attrs["i"] for r in rounds] == list(range(p.iters))
    want = ["search.select", "search.gather", "search.dedup", "search.score", "search.merge"]
    want += ["search.twin_pool"] if keywords else []
    assert all([c.name for c in r.children] == want for r in rounds)
    assert [c.name for c in root.children[-1].children] == [
        "search.filter", "search.rescore", "search.fuse"]
    _assert_nested(ctx.root.children[0])
    width = index.semantic_edges.shape[1] + (index.keyword_edges.shape[1] if keywords else 0)
    slots = p.iters * corpus.queries.n * p.expand * width
    c = ctx.counters
    assert c["search.rounds"] == p.iters and c["search.edge_slots"] == slots
    assert isinstance(c["search.fresh_candidates"], int)
    assert 0 < c["search.fresh_candidates"] <= slots


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------

STAGES = ["descent", "refinement", "prune", "entry_points", "logical_edges"]


def test_traced_seal_has_the_stage_spans_in_order(corpus):
    docs = corpus.docs[:N_DOCS]
    with obs.tracing(TraceContext("seal")) as ctx:
        build_pool_segment(docs, np.arange(N_DOCS), BUILD, capacity=256,
                           generator=torch.Generator().manual_seed(1), corpus_dtype="int8",
                           device="cpu")
    (seal,) = ctx.root.children
    assert seal.name == "seal" and seal.attrs["corpus_dtype"] == "int8"
    assert [c.name for c in seal.children] == ["build", "seal.pad_quantize"]
    build = seal.children[0]
    assert [c.name for c in build.children] == [f"build.{s}" for s in STAGES]
    descent, refinement, prune = build.children[:3]
    assert [c.name for c in descent.children] == (
        ["build.descent.init"] + ["build.descent.round"] * BUILD.knn.iters)
    assert [c.attrs["path"] for c in refinement.children] == [0, 1, 2]
    assert all([c.name for c in path.children] == (
        ["build.refinement.init"] + ["build.refinement.round"] * BUILD.path_refine_iters)
        for path in refinement.children)
    chunks = math.ceil(N_DOCS / BUILD.prune.node_chunk)
    assert [c.name for c in prune.children] == (
        ["build.prune.self_scores"] + ["build.prune.chunk"] * chunks)
    assert [c.attrs["start"] for c in prune.children[1:]] == list(
        range(0, N_DOCS, BUILD.prune.node_chunk))
    _assert_nested(ctx.root.children[0])


@pytest.mark.parametrize("outer", [False, True], ids=["own-context", "in-a-trace"])
def test_report_stage_seconds_come_from_the_stage_spans(corpus, outer):
    report: dict = {}
    ctx = TraceContext("outer") if outer else None
    with obs.tracing(ctx):
        index = build_index(corpus.docs[:96], BUILD, generator=torch.Generator().manual_seed(2),
                            device="cpu", report=report)
    assert list(report["stage_seconds"]) == STAGES
    assert all(v >= 0 for v in report["stage_seconds"].values())
    assert report["knn_ids"].shape == (96, BUILD.knn.k) and index.n == 96
    if outer:
        (build,) = ctx.find("build")
        assert report["stage_seconds"] == {
            c.name.removeprefix("build."): c.duration for c in build.children}
    assert obs.active() is None


# ---------------------------------------------------------------------------
# the clock: spans on the profiler's
# ---------------------------------------------------------------------------


def test_a_span_on_the_profilers_clock_contains_the_ops_issued_in_it():
    from torch.profiler import ProfilerActivity, profile

    a = torch.randn(192, 192)
    ctx = TraceContext("clock")
    with profile(activities=[ProfilerActivity.CPU]) as prof, obs.tracing(ctx):
        time.sleep(0.001)
        with obs.span("matmul") as span:
            a @ a
        time.sleep(0.001)
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    (mm,) = [e for e in prof.events() if e.name == "aten::mm"]
    op0 = start_ns + round(mm.time_range.start * 1e3)
    op1 = start_ns + round(mm.time_range.end * 1e3)
    s0, s1 = ctx.unix_ns(span.t0), ctx.unix_ns(span.t1)
    slack = 5_000  # ns: the pair's two reads, and the float seconds of a span
    assert s0 - slack <= op0 <= op1 <= s1 + slack, (s0, op0, op1, s1)
    assert s1 - s0 < 1e9 * (span.t1 - span.t0) + slack


# ---------------------------------------------------------------------------
# the service
# ---------------------------------------------------------------------------


def test_a_traced_batch_hangs_the_core_spans_under_device_dispatch(corpus, index):
    svc = HybridSearchService(index, _params(False), ServiceConfig(batcher=BatcherConfig(
        flush_size=4, max_batch=4, kw_cap=4, ent_cap=2, flush_deadline_s=60.0)))
    traced, plain = TraceContext("q0"), None
    pend = [svc.submit(SearchRequest(query=corpus.queries[i], fusion=FusionSpec.three_path(),
                                     k=5, trace=traced if i == 0 else plain))
            for i in range(3)]
    svc.flush()
    want = _search(corpus, index, False)
    ids, _ = pend[0].result()
    np.testing.assert_array_equal(ids, want.ids[0].numpy())
    (dispatch,) = traced.find("device_dispatch")
    (core,) = dispatch.children
    assert core.name == "search" and core.attrs["B"] == 4  # the padded bucket
    assert len([c for c in core.children if c.name == "search.round"]) == _params(False).iters
    _assert_nested(dispatch)
    assert traced.counters["search.rounds"] == _params(False).iters
    assert obs.active() is None
    # an untraced batch records nothing
    svc.submit(SearchRequest(query=corpus.queries[0], fusion=FusionSpec.three_path(), k=5))
    svc.flush()
    assert len(traced.find("search")) == 1


def test_new_shape_keys_counts_first_batches_per_key(index, corpus):
    svc = HybridSearchService(index, _params(False), ServiceConfig(batcher=BatcherConfig(
        flush_size=2, max_batch=2, flush_deadline_s=60.0)))
    for _ in range(2):
        for i in range(2):
            svc.submit(SearchRequest(query=corpus.queries[i], fusion=FusionSpec.three_path(),
                                     k=3))
        svc.flush()
    assert svc.stats.new_shape_keys == 1 and svc.stats.batches == 2
    assert svc.metrics.value("allanpoe_serving_new_shape_keys_total") == 1
    assert "new_shape_keys=1" in repr(svc.stats)
    assert not hasattr(svc.stats, "compiles")
