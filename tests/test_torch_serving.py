"""The port's serving layer against repro's: the obs copies (metrics registry,
histograms, spans, exposition), the micro-batcher and admission control, the
fusion merge helpers and corpus stats, and ``HybridSearchService``.

Service parity: one repro-built two-segment pool, in fp32 and in int8 storage,
is served by both packages' services with the same 12 requests (three bucket
shapes, all four fusion modes, keywords on and off): the same ids up to ties,
scores to 1e-4, and the port's ``stats.new_shape_keys`` equal to repro's
``stats.compiles``. Service behaviour mirrors
tests/test_hybrid_service.py and tests/test_obs.py, without wall-clock
ratios.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small tensors: threads only contend with the other workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import BuildConfig as RBuildConfig  # noqa: E402
from repro.core import KnnConfig as RKnnConfig  # noqa: E402
from repro.core import PruneConfig as RPruneConfig  # noqa: E402
from repro.core import build_index as r_build_index  # noqa: E402
from repro.core import fusion as rfusion  # noqa: E402
from repro.core import segment_pool as rpool  # noqa: E402
from repro.core import usms as rusms  # noqa: E402
from repro.core.search import SearchParams as RSearchParams  # noqa: E402
from repro.data.corpus import CorpusConfig, make_corpus  # noqa: E402
from repro.serving import batcher as rbatcher  # noqa: E402
from repro.serving import hybrid_service as rsvc  # noqa: E402
from repro_torch.convert import corpus_from_arrays, fused_from_numpy  # noqa: E402
from repro_torch.convert import index_from_arrays, pool_from_arrays  # noqa: E402
from repro_torch.core import distributed as tdist  # noqa: E402
from repro_torch.core import fusion as tfusion  # noqa: E402
from repro_torch.core import usms as tusms  # noqa: E402
from repro_torch.core.search import SearchParams, search  # noqa: E402
from repro_torch.core.segment_pool import SegmentPool  # noqa: E402
from repro_torch.obs.export import chrome_trace  # noqa: E402
from repro_torch.obs.metrics import GLOBAL, MetricsRegistry  # noqa: E402
from repro_torch.obs.metrics import merged_snapshot, time_buckets  # noqa: E402
from repro_torch.obs.tracer import TraceContext, Tracer  # noqa: E402
from repro_torch.serving import batcher as tbatcher  # noqa: E402
from repro_torch.serving.batcher import (  # noqa: E402
    AdmissionConfig,
    AdmissionError,
    BatcherConfig,
    PendingResult,
    QueueFullError,
    QuotaConfig,
    SearchRequest,
)
from repro_torch.serving.hybrid_service import (  # noqa: E402
    HybridSearchService,
    ServiceConfig,
    ServiceStats,
)

TOL = 1e-4
MODES = ("weighted_sum", "minmax", "zscore", "rrf")
R_BUILD = RBuildConfig(knn=RKnnConfig(k=12, iters=3, node_chunk=512, use_kernel=False),
                       prune=RPruneConfig(degree=12, keyword_degree=4, node_chunk=256,
                                          use_kernel=False), path_refine_iters=0)
PARAMS = dict(k=8, iters=16, pool_size=48, use_keywords=True)


def to_torch(f):
    a = np.asarray
    return fused_from_numpy(a(f.dense), a(f.learned.idx), a(f.learned.val),
                            a(f.lexical.idx), a(f.lexical.val), "cpu")


@pytest.fixture(scope="module")
def corpus():
    return make_corpus(CorpusConfig(n_docs=256, n_queries=16, n_topics=12, d_dense=24,
                                    nnz_sparse=10, nnz_lexical=8, seed=31))


@pytest.fixture(scope="module")
def index(corpus):
    """A repro-built single index, carried into the port."""
    return index_from_arrays(r_build_index(jax.tree.map(jnp.asarray, corpus.docs[:224]),
                                           R_BUILD), "cpu")


@pytest.fixture(scope="module")
def tq(corpus):
    return to_torch(corpus.queries)


def _service(index, params=None, **batcher_kw):
    kw = dict(flush_size=8, max_batch=8, kw_cap=4, ent_cap=2, flush_deadline_s=60.0)
    kw.update(batcher_kw)
    return HybridSearchService(index, params or SearchParams(**PARAMS),
                               ServiceConfig(batcher=BatcherConfig(**kw)))


W3 = [tusms.PathWeights.make(1.0, 0.0, 0.0), tusms.PathWeights.make(0.0, 1.0, 1.0),
      tusms.PathWeights.make(0.5, 0.25, 1.0)]


# ---------------------------------------------------------------------------
# obs copies
# ---------------------------------------------------------------------------


def test_counter_labels_totals_and_registry_checks():
    reg = MetricsRegistry()
    c = reg.counter("x_total", "things", labels=("kind",))
    c.inc(kind="a")
    c.inc(2, kind="b")
    assert (c.value(kind="a"), c.value(kind="b"), c.total()) == (1, 2, 3)
    with pytest.raises(ValueError):
        c.inc(-1, kind="a")
    with pytest.raises(ValueError):
        c.inc(bogus="a")
    assert reg.counter("x_total", "", labels=("kind",)) is c  # idempotent
    with pytest.raises(ValueError):
        reg.gauge("x_total")
    with pytest.raises(ValueError):
        reg.counter("x_total", "", labels=("y",))


def test_counter_increments_are_atomic_across_8_threads():
    stats = ServiceStats(MetricsRegistry())
    n_threads, n_incs = 8, 2000

    def hammer(reason):
        for _ in range(n_incs):
            stats._rejected.inc(reason=reason)

    threads = [threading.Thread(target=hammer, args=("queue_full" if i % 2 else "admission",))
               for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert stats.rejected_queue_full == stats.rejected_admission == 4 * n_incs
    assert stats.rejected == n_threads * n_incs


def test_histogram_quantiles_and_windows():
    reg = MetricsRegistry()
    h = reg.histogram("lat_seconds", "")
    samples = np.random.default_rng(3).lognormal(mean=-4.0, sigma=1.0, size=4000)
    for s in samples:
        h.observe(float(s))
    snap = h.snapshot()
    assert snap.count == len(samples)
    for q in (0.5, 0.99):
        exact = float(np.quantile(samples, q))
        assert abs(snap.quantile(q) - exact) / exact < 0.15
    before = h.snapshot()
    for _ in range(5):
        h.observe(10.0)
    delta = h.snapshot().minus(before)
    assert delta.count == 5 and delta.quantile(0.5) > 5.0
    b = time_buckets(1e-4, 60.0, ratio=1.25)
    assert all(x < y for x, y in zip(b, b[1:]))


def test_prometheus_render_and_snapshot():
    reg = MetricsRegistry()
    c = reg.counter("allanpoe_test_requests_total", "reqs", labels=("mode",))
    reg.gauge("allanpoe_test_depth", "queue depth").set(7)
    reg.histogram("allanpoe_test_wait_seconds", "queue wait").observe(0.01)
    c.inc(3, mode="rrf")
    text = reg.render()
    assert 'allanpoe_test_requests_total{mode="rrf"} 3' in text
    assert "allanpoe_test_depth 7" in text
    assert 'allanpoe_test_wait_seconds_bucket{le="+Inf"} 1' in text
    snap = reg.snapshot()
    assert snap["allanpoe_test_requests_total"]["series"][0]["value"] == 3
    assert "p99" in snap["allanpoe_test_wait_seconds"]["series"][0]
    json.dumps(snap)
    assert "allanpoe_test_depth" in merged_snapshot(reg, MetricsRegistry())


def test_trace_context_tree_and_chrome_export(tmp_path):
    tracer = Tracer()
    with tracer.trace("query", tenant="t0") as ctx:
        with ctx.span("phase_a") as a:
            a.annotate(rows=3)
        t0 = time.perf_counter()
        ctx.add_span("phase_b", t0, t0 + 0.01, hit=True)
    names = ctx.span_names()
    assert names[0] == "query" and {"phase_a", "phase_b"} <= set(names)
    doc = tracer.export_chrome(tmp_path / "trace.json")
    loaded = json.loads((tmp_path / "trace.json").read_text())
    assert loaded == json.loads(json.dumps(doc))
    events = [e for e in loaded["traceEvents"] if e["ph"] == "X"]
    assert {e["name"] for e in events} >= {"query", "phase_a", "phase_b"}
    assert any(e["args"].get("hit") is True for e in events)
    s = TraceContext("q").add_span("x", 5.0, 4.0)
    assert s.t1 == s.t0 == 5.0
    assert chrome_trace([ctx])["traceEvents"]


# ---------------------------------------------------------------------------
# batcher and admission
# ---------------------------------------------------------------------------


def test_token_bucket_and_admission_match_repro():
    for mod in (tbatcher, rbatcher):
        tb = mod.TokenBucket(mod.QuotaConfig(rate=2.0, burst=4.0), now=0.0)
        assert all(tb.try_acquire(1.0, now=0.0) for _ in range(4))
        assert not tb.try_acquire(1.0, now=0.0)
        assert tb.try_acquire(1.0, now=0.5)
        cfg = mod.AdmissionConfig(
            global_quota=mod.QuotaConfig(rate=0.0, burst=3.0),
            default_tenant_quota=mod.QuotaConfig(rate=0.0, burst=1.0),
            tenant_quotas=(("vip", mod.QuotaConfig(rate=0.0, burst=2.0)),),
        )
        ac = mod.AdmissionController(cfg, now=0.0)
        seq = [ac.try_admit(t, now=0.0) for t in ("basic", "basic", "vip", "vip", "vip", None)]
        assert seq == [True, False, True, True, False, False]


def test_bucket_shapes_match_repro():
    for mod in (tbatcher, rbatcher):
        mb = mod.MicroBatcher(mod.BatcherConfig(flush_size=8, max_batch=16, kw_cap=8, ent_cap=4))
        for i in range(5):
            mb.enqueue(mod.SearchRequest(query=None, keywords=np.arange(3) if i == 0 else None,
                                         entities=np.arange(2) if i == 1 else None),
                       mod.PendingResult(), now=float(i))
        [(bucket, entries)] = mb.take_ready(force=True)
        assert len(entries) == 5 and len(mb) == 0
        assert (bucket.batch, bucket.kw_width, bucket.ent_width) == (8, 4, 2)


# ---------------------------------------------------------------------------
# fusion helpers and corpus stats
# ---------------------------------------------------------------------------


def _stats_close(got, want, rtol=1e-5):
    for f in ("minv", "maxv", "mean", "std"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=rtol, atol=1e-6)


@pytest.mark.parametrize("quantized", [False, True])
def test_path_stats_match_repro(corpus, quantized):
    docs = jax.tree.map(jnp.asarray, corpus.docs)
    if quantized:
        docs = rusms.quantize_corpus(docs)
    alive = np.arange(corpus.docs.dense.shape[0]) % 5 != 0
    t_docs = corpus_from_arrays(docs, "cpu")
    want = rfusion.PathStats.from_corpus_parts([(docs, alive), (docs[:10], None)])
    got = tfusion.PathStats.from_corpus_parts([(t_docs, torch.as_tensor(alive)),
                                               (t_docs[:10], None)])
    _stats_close(got, want)
    _stats_close(tfusion.PathStats.ema(got, tfusion.PathStats.identity(), 0.3),
                 rfusion.PathStats.ema(want, rfusion.PathStats.identity(), 0.3))
    _stats_close(tfusion.PathStats.merge([got, tfusion.PathStats.identity()], [40, 10]),
                 rfusion.PathStats.merge([want, rfusion.PathStats.identity()], [40, 10]))
    all_dead = tfusion.PathStats.from_corpus(t_docs, torch.zeros(alive.shape, dtype=torch.bool))
    _stats_close(all_dead, rfusion.PathStats.identity())


def _specs(pkg, b):
    return [pkg.FusionSpec.make(MODES[i % 4], 1.0, 0.5 + i / 10, 0.3,
                                stats=pkg.PathStats.identity()) for i in range(b)]


def test_stack_specs_and_merges_match_repro():
    rng = np.random.default_rng(9)
    s, b, k = 3, 4, 5
    g = rng.permutation(100)[: s * b * k].reshape(s, b, k).astype(np.int32)
    g[0, 1, 3:] = -1
    sc = rng.normal(size=(s, b, k)).astype(np.float32)
    sc[g < 0] = -np.inf
    ps = rng.normal(size=(s, b, k, 3)).astype(np.float32)
    ps[:, 2, :2] = ps[:, 2, 2:4]  # planted path-score ties
    t_spec = tfusion.stack_specs(_specs(tfusion, b))
    r_spec = rfusion.stack_specs(_specs(rfusion, b))
    assert t_spec.mode.dtype == torch.int32
    np.testing.assert_array_equal(t_spec.mode.numpy(), np.asarray(r_spec.mode))
    np.testing.assert_allclose(t_spec.score_weights().numpy(), np.asarray(r_spec.score_weights()))
    with pytest.raises(ValueError):
        tfusion.stack_specs([tfusion.FusionSpec.three_path(), _specs(tfusion, 1)[0]])
    got = tfusion.merge_rows_fused(*(torch.as_tensor(x) for x in (g, sc, ps)), t_spec, k)
    want = rfusion.merge_rows_fused(jnp.asarray(g), jnp.asarray(sc), jnp.asarray(ps), r_spec, k)
    for x, y in zip(got, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-6)
    parts = [g[i] for i in range(s)], [sc[i] for i in range(s)], [ps[i] for i in range(s)]
    got_h = tfusion.merge_fused_host(*parts, t_spec, k)
    want_h = rfusion.merge_fused_host(*parts, r_spec, k)
    for x, y in zip(got_h, want_h):
        np.testing.assert_allclose(x, np.asarray(y), rtol=1e-6)
    with pytest.raises(ValueError, match="merge contract"):
        tfusion.merge_fused_host(parts[0], parts[1], None, t_spec, k)
    from repro.core import distributed as rdist

    got_t = tdist._merge_rows_topk(torch.as_tensor(g), torch.as_tensor(sc), k)
    want_t = rdist._merge_rows_topk(jnp.asarray(g), jnp.asarray(sc), k)
    for x, y in zip(got_t, want_t):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


# ---------------------------------------------------------------------------
# service parity over a repro-built pool, fp32 and int8
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pools(corpus):
    docs = jax.tree.map(jnp.asarray, corpus.docs)
    pool = rpool.SegmentPool(groups=[])
    for s, (lo, hi) in enumerate(((0, 112), (112, 224))):
        seg = rpool.build_pool_segment(docs[lo:hi], np.arange(lo, hi, dtype=np.int32), R_BUILD,
                                       capacity=128, key=jax.random.key(s))
        pool, _ = rpool.append_segment(pool, seg)
    g = pool.groups[0]
    pool_q = rpool.SegmentPool(groups=[dataclasses.replace(g, index=dataclasses.replace(
        g.index, corpus=rusms.quantize_corpus(g.index.corpus)))])
    return {"float32": pool, "int8": pool_q}


def _requests(pkg, corpus, queries):
    """12 requests: 4 without keywords (bucket 4x1x1), 4 with up to 3 (4x4x1)
    and 4 flushed as 2 + 2 (2x1x1 and 2x2x1); all four fusion modes."""
    lex = np.asarray(corpus.docs.lexical.idx)
    out = []
    for i in range(12):
        kw = None
        if 4 <= i < 8:
            kw = lex[i, : 1 + i % 3]
        elif i >= 10:
            kw = lex[i, :2]
        spec = pkg.FusionSpec.make(MODES[i % 4], 1.0, 0.4 + 0.1 * (i % 3), 0.6)
        out.append((queries[i], spec, kw))
    return out


def _serve(svc, reqs, req_cls):
    pend = []
    for j, (q, spec, kw) in enumerate(reqs):
        kw = None if kw is None else np.asarray(kw[kw >= 0])
        pend.append(svc.submit(req_cls(query=q, fusion=spec, k=6, keywords=kw)))
        if j in (3, 7, 9, 11):
            svc.flush()
    return [p.result() for p in pend], [p.path_scores for p in pend]


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_service_parity_with_repro_on_pool(corpus, pools, dtype):
    r_pool = pools[dtype]
    batch = dict(flush_size=4, max_batch=4, kw_cap=4, ent_cap=2, flush_deadline_s=60.0)
    r_svc = rsvc.HybridSearchService(
        r_pool, RSearchParams(use_kernel=False, corpus_dtype=dtype, **PARAMS),
        rsvc.ServiceConfig(batcher=rbatcher.BatcherConfig(**batch)))
    # the byte gauges are process-wide: only this service's labels, not those
    # of services an earlier test file built in the same process
    GLOBAL.get("allanpoe_index_bytes_total").reset()
    t_svc = HybridSearchService(
        pool_from_arrays(r_pool, "cpu"), SearchParams(corpus_dtype=dtype, **PARAMS),
        ServiceConfig(batcher=BatcherConfig(**batch)))
    want, want_ps = _serve(r_svc, _requests(rfusion, corpus, jax.tree.map(
        jnp.asarray, corpus.queries)), rbatcher.SearchRequest)
    got, got_ps = _serve(t_svc, _requests(tfusion, corpus, to_torch(corpus.queries)),
                         SearchRequest)
    for (gi, gs), (wi, ws), gp, wp in zip(got, want, got_ps, want_ps):
        np.testing.assert_allclose(gs, np.asarray(ws), rtol=TOL, atol=TOL)
        assert np.all(np.abs(gs - np.asarray(ws))[gi != np.asarray(wi)] <= TOL), (gi, wi)
        np.testing.assert_allclose(gp, np.asarray(wp), rtol=TOL, atol=TOL)
    assert t_svc.stats.new_shape_keys == r_svc.stats.compiles == 4
    assert t_svc.stats.batches == r_svc.stats.batches == 4
    assert t_svc.stats.padded_slots == r_svc.stats.padded_slots == 0
    _stats_close(t_svc.path_stats, r_svc.path_stats)
    # the index-bytes gauges: int8 dense + f32 scale + f16 values when sealed
    by = {k: v for k, v in GLOBAL.get("allanpoe_index_bytes_total").values().items() if v}
    dense_dtype = "int8" if dtype == "int8" else "float32"
    assert by[("dense", dense_dtype)] == 2 * 128 * 24 * (1 if dtype == "int8" else 4)
    assert (("dense_scale", "float32") in by) == (dtype == "int8")


# ---------------------------------------------------------------------------
# service behaviour on one index
# ---------------------------------------------------------------------------


def test_service_matches_direct_search_and_pads(corpus, index, tq):
    svc = _service(index)
    reqs = []
    for i in range(6):  # 6 requests -> padded to the 8-slot bucket
        kws = None
        if i % 3 == 0:
            kws = np.asarray(corpus.docs.lexical.idx[i, :2])
            kws = kws[kws >= 0]
        reqs.append(SearchRequest(query=tq[i], weights=W3[i % 3], k=5, keywords=kws))
    pend = [svc.submit(r) for r in reqs]
    svc.flush()
    assert svc.stats.padded_slots == 2
    for i, (r, p) in enumerate(zip(reqs, pend)):
        ids, scores = p.result()
        kw2d = None if r.keywords is None else np.asarray(r.keywords)[None, :]
        ref = search(index, tq[i:i + 1], r.weights, SearchParams(**PARAMS), keywords=kw2d,
                     device="cpu")
        np.testing.assert_array_equal(ids, ref.ids[0, :5].numpy())
        np.testing.assert_allclose(scores, ref.scores[0, :5].numpy(), rtol=1e-6)


def test_one_callable_per_bucket_across_weight_mixes(corpus, index, tq):
    svc = _service(index)
    for rep in range(3):
        for w in W3:
            svc.submit(SearchRequest(query=tq[rep], weights=w, k=4))
    svc.flush()
    assert svc.stats.requests == 9
    assert len(svc.executable_cache) == 2 == svc.stats.new_shape_keys  # 8-slot + 1-slot tail
    before = svc.stats.new_shape_keys
    for mode in MODES:
        for i in range(8):
            svc.submit(SearchRequest(query=tq[i], fusion=tfusion.FusionSpec.make(
                mode, 0.1 + i / 8, 0.9, 0.4), k=4))
    svc.flush()
    assert svc.stats.new_shape_keys == before and len(svc.executable_cache) == 2
    assert svc.metrics.value("allanpoe_serving_executable_cache_total", outcome="hit") == 4
    # a new keyword width is a new bucket shape
    for i in range(8):
        svc.submit(SearchRequest(query=tq[i], weights=W3[1], k=4, keywords=np.asarray([3, 5, 7])))
    svc.flush()
    assert svc.stats.new_shape_keys == before + 1


def test_fp32_params_over_int8_storage_raise(index):
    idx_q = dataclasses.replace(index, corpus=tusms.quantize_corpus(index.corpus))
    with pytest.raises(ValueError, match="corpus_dtype"):
        _service(idx_q)
    with pytest.raises(ValueError, match="corpus_dtype"):
        _service(SegmentPool(groups=[tdist.SegmentedIndex(
            tdist.map_index(idx_q, lambda t: t[None]), torch.arange(idx_q.n)[None].int())]))
    svc = _service(idx_q, SearchParams(corpus_dtype="int8", **PARAMS))
    assert svc.params.corpus_dtype == "int8"
    _service(index, SearchParams(corpus_dtype="int8", **PARAMS))  # int8 over fp32: allowed


def test_queue_full_and_admission_rejects(index, tq):
    svc = _service(index, max_queue=2)
    for i in range(2):
        svc.submit(SearchRequest(query=tq[i], weights=W3[0], k=3))
    with pytest.raises(QueueFullError):
        svc.submit(SearchRequest(query=tq[2], weights=W3[0], k=3))
    assert (svc.stats.rejected_queue_full, svc.stats.rejected_admission, svc.stats.requests) == (
        1, 0, 2)
    svc.flush()
    assert not issubclass(AdmissionError, QueueFullError)
    svc = HybridSearchService(index, SearchParams(**PARAMS), ServiceConfig(
        batcher=BatcherConfig(flush_size=8, max_batch=8, max_queue=1, flush_deadline_s=60.0),
        admission=AdmissionConfig(global_quota=QuotaConfig(rate=0.0, burst=3.0))))
    req = lambda i: SearchRequest(query=tq[i], weights=W3[0], k=3)
    svc.submit(req(0))
    with pytest.raises(QueueFullError):  # token taken and refunded
        svc.submit(req(1))
    svc.flush()
    svc.submit(req(2))
    svc.flush()
    svc.submit(req(3))
    with pytest.raises(AdmissionError):
        svc.submit(req(4))
    assert (svc.stats.requests, svc.stats.rejected_admission, svc.stats.rejected_queue_full) == (
        3, 1, 1)
    svc.flush()


def test_request_validation(index, tq):
    svc = _service(index)
    with pytest.raises(ValueError):
        svc.submit(SearchRequest(query=tq[0], weights=W3[0], k=PARAMS["k"] + 1))
    with pytest.raises(ValueError):
        svc.submit(SearchRequest(query=tq[0], weights=W3[0], keywords=np.arange(5)))
    with pytest.raises(ValueError):
        svc.submit(SearchRequest(query=tq[0], weights=W3[0], entities=np.asarray([1])))
    with pytest.raises(ValueError):
        svc.submit(SearchRequest(query=tq[0]))


def test_mark_deleted_swaps_without_recompiling(index, tq):
    svc = _service(index, flush_size=2, max_batch=2)
    w = tusms.PathWeights.make(1.0, 0.5, 0.5)
    r0 = svc.search(tq[:2], w, k=3)
    new_keys = svc.stats.new_shape_keys
    top = int(r0.ids[0, 0])
    assert svc.mark_deleted(np.asarray([top])) == 1 == svc.snapshot_version
    r1 = svc.search(tq[:2], w, k=3)
    assert top not in r1.ids[0].tolist()
    assert svc.stats.new_shape_keys == new_keys
    assert bool(index.alive[top])  # copy-on-write: the served index was replaced


def test_deadline_flush_through_the_pump(index, tq):
    """A lone request below flush_size is run by the pump thread once its
    deadline lapses (completion proves it; no timing ratios)."""
    svc = HybridSearchService(index, SearchParams(**PARAMS), ServiceConfig(
        batcher=BatcherConfig(flush_size=4, max_batch=4, flush_deadline_s=0.02),
        pump_interval_s=0.005))
    try:
        pend = [svc.submit(SearchRequest(query=tq[i], weights=W3[0], k=3)) for i in range(3)]
        t0 = time.monotonic()
        while not all(p.done for p in pend) and time.monotonic() - t0 < 30.0:
            time.sleep(0.005)
        assert all(p.done for p in pend)
        assert svc.stats.batches == 1 and svc.stats.padded_slots == 1
    finally:
        svc.stop_pump()
    assert svc._pump_thread is None


def test_failed_batch_fails_waiters_and_spares_siblings(index, tq):
    svc = _service(index, flush_size=2, max_batch=2)
    pend = []
    for i in range(3):
        p = PendingResult(service=svc)
        svc._batcher.enqueue(SearchRequest(query=tq[i], weights=W3[0], k=3), p)
        pend.append(p)
    orig, calls = svc._assemble, []

    def boom(bucket, entries, device):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("injected batch failure")
        return orig(bucket, entries, device)

    svc._assemble = boom
    with pytest.raises(RuntimeError, match="injected"):
        svc.flush()
    assert all(p.done for p in pend)
    with pytest.raises(RuntimeError, match="injected"):
        pend[0].result()
    assert pend[2].result()[0].shape == (3,)


def test_search_strips_pad_keywords_and_splits_batched_specs(corpus, index, tq):
    svc = _service(index, flush_size=4, max_batch=4)
    kw2d = np.full((4, 8), -1, np.int32)
    lex = np.asarray(corpus.docs.lexical.idx[:4, :2])
    kw2d[:, :2] = lex
    w = tusms.PathWeights.make(1.0, 1.0, 1.0)
    res = svc.search(tq[:4], w, keywords=kw2d, k=5)
    ref = search(index, tq[:4], w, SearchParams(**PARAMS), keywords=kw2d, device="cpu")
    np.testing.assert_array_equal(res.ids.numpy(), ref.ids[:, :5].numpy())
    assert (res.expanded > 0).all()
    wb = tusms.stack_weights(W3 + [tusms.PathWeights.make(0.2, 0.8, 0.5)])
    res = svc.search(tq[:4], wb, k=4)
    ref = search(index, tq[:4], wb, SearchParams(**PARAMS), device="cpu")
    np.testing.assert_array_equal(res.ids.numpy(), ref.ids[:, :4].numpy())


def test_concurrent_submit_and_poll(index, tq):
    svc = _service(index, flush_size=4, max_batch=8, flush_deadline_s=0.001, max_queue=4096)
    results = [None] * 24
    stop = threading.Event()

    def pump():
        while not stop.is_set():
            svc.poll()
            time.sleep(0.001)

    def client(base):
        for i in range(8):
            results[base + i] = svc.submit(SearchRequest(query=tq[(base + i) % 16],
                                                         weights=W3[i % 3], k=3))

    pumper = threading.Thread(target=pump)
    pumper.start()
    workers = [threading.Thread(target=client, args=(b,)) for b in (0, 8, 16)]
    for t in workers:
        t.start()
    for t in workers:
        t.join(timeout=120)
    svc.flush()
    stop.set()
    pumper.join(timeout=60)
    assert not pumper.is_alive() and not any(t.is_alive() for t in workers)
    assert all(p.done for p in results) and svc.stats.requests == 24
    for p in results:
        assert p.result()[0].shape == (3,)


def test_span_tree_metrics_and_unported_paths(corpus, index, tq):
    svc = _service(index, flush_size=4, max_batch=4)
    spec = tfusion.FusionSpec.three_path()
    with svc.tracer.trace("request") as ctx:
        for i in range(4):
            svc.submit(SearchRequest(query=tq[i], fusion=spec, k=PARAMS["k"], trace=ctx))
        svc.flush()
    assert {"admission", "queue_wait", "batch_assembly", "executable_lookup",
            "device_dispatch"} <= set(ctx.span_names())
    assert ctx.find("executable_lookup")[0].attrs.get("hit") is False
    assert svc.metrics.value("allanpoe_serving_requests_total", mode="weighted_sum") == 4
    lat = svc.metrics.get("allanpoe_serving_request_latency_seconds").snapshot()
    assert lat.count == 4 and lat.quantile(0.99) >= lat.quantile(0.5) > 0
    by = GLOBAL.get("allanpoe_index_bytes_total")
    svc2 = _service(index)  # the most recent publisher sets the gauges
    assert by.value(leaf="dense", dtype="float32") == index.corpus.dense.numel() * 4
    assert by.value(leaf="graph", dtype="int32") > 0
    # the write path: a single index takes inserts given a build config, a
    # pool takes deletes and inserts through an attached router
    with pytest.raises(ValueError, match="build_cfg"):
        svc2.insert(to_torch(corpus.docs[:1]))
    from repro_torch.core.index import BuildConfig
    from repro_torch.core.knn_graph import KnnConfig
    from repro_torch.core.pruning import PruneConfig
    from repro_torch.serving.segment_router import SegmentRouter

    build = BuildConfig(knn=KnnConfig(k=12, iters=3), prune=PruneConfig(degree=12,
                        keyword_degree=4), path_refine_iters=0)
    svc3 = HybridSearchService(index, SearchParams(**PARAMS), build_cfg=build)
    assert svc3.insert(to_torch(corpus.docs[224:232])) == 1 and svc3.index.n == 232
    pool_svc = HybridSearchService(SegmentPool.from_segmented(tdist.SegmentedIndex(
        tdist.map_index(index, lambda a: a[None]),
        torch.arange(index.n, dtype=torch.int32)[None])), SearchParams(**PARAMS))
    with pytest.raises(ValueError, match="SegmentRouter"):
        pool_svc.mark_deleted([3])
    router = SegmentRouter(pool_svc, build)
    assert pool_svc.mark_deleted([3]) == 1 and router.stats.deleted_sealed == 1
    assert pool_svc.insert(to_torch(corpus.docs[224:232])) == 2 and router.grow_size == 8
    with pytest.raises(RuntimeError, match="process group"):
        HybridSearchService(index, SearchParams(**PARAMS), mesh=object())
