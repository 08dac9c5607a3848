"""The port's serving engine and RAG pipeline (``repro_torch.serving.engine``,
``repro_torch.serving.rag``, ``repro_torch.launch.serve``) against repro's,
on the llama3.2-1b smoke config at fp32 (vocab 256, as tests/test_serving.py)
with parameters carried across by ``convert.py``: greedy generation gives
repro's tokens exactly (naive and flash attention); ``RagPipeline.answer``,
direct and through ``HybridSearchService``, over a small repro-built index
carried across, gives repro's ids and tokens exactly, and so do
``retrieve_text`` and ``answer_text`` over the bundled text corpus (adaptive
fusion on and off), with the fitted ingest pipeline carried across by
``convert.ingest_pipeline_from_arrays``. Also the port's own
checks: generation equals incremental forward passes
(tests/test_serving.py:41), argmax ties go to the first index, temperature
sampling's shape and determinism, the trace spans, the CLI on the CPU, and
entry points that default to CUDA.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small tensors: threads only contend with the other workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as r_smoke_config  # noqa: E402
from repro.core import BuildConfig as RBuildConfig  # noqa: E402
from repro.core import KnnConfig as RKnnConfig  # noqa: E402
from repro.core import PruneConfig as RPruneConfig  # noqa: E402
from repro.core import build_index as r_build_index  # noqa: E402
from repro.core.search import SearchParams as RSearchParams  # noqa: E402
from repro.data.corpus import CorpusConfig, make_corpus  # noqa: E402
from repro.data.textcorpus import load_bundled_corpus  # noqa: E402
from repro.ingest import IngestConfig as RIngestConfig  # noqa: E402
from repro.ingest import IngestPipeline as RIngestPipeline  # noqa: E402
from repro.models import transformer as rtfm  # noqa: E402
from repro.serving import batcher as rbatcher  # noqa: E402
from repro.serving import engine as rengine  # noqa: E402
from repro.serving import hybrid_service as rsvc  # noqa: E402
from repro.serving import rag as rrag  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import fused_from_numpy, index_from_arrays  # noqa: E402
from repro_torch.convert import ingest_pipeline_from_arrays, model_params_from_numpy  # noqa: E402
from repro_torch.ingest import IngestConfig, IngestPipeline  # noqa: E402
from repro_torch.core.search import SearchParams  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.obs.tracer import TraceContext  # noqa: E402
from repro_torch.serving.batcher import BatcherConfig  # noqa: E402
from repro_torch.serving.engine import ServeConfig, ServingEngine  # noqa: E402
from repro_torch.serving.hybrid_service import HybridSearchService, ServiceConfig  # noqa: E402
from repro_torch.serving.rag import RagConfig, RagPipeline  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCH = "llama3.2-1b"
R_BUILD = RBuildConfig(knn=RKnnConfig(k=12, iters=3, node_chunk=512, use_kernel=False),
                       prune=RPruneConfig(degree=12, keyword_degree=4, node_chunk=256,
                                          use_kernel=False), path_refine_iters=0)
SEARCH = dict(k=5, iters=24, pool_size=48)


def _cfgs(impl):
    base = dict(dtype="float32", vocab=256, attn_impl=impl)
    return (dataclasses.replace(r_smoke_config(ARCH), **base),
            dataclasses.replace(get_smoke_config(ARCH), **base))


@pytest.fixture(scope="module", params=["naive", "flash"])
def engines(request):
    """repro's engine and the port's, on the same fp32 parameters."""
    rcfg, tcfg = _cfgs(request.param)
    params = rtfm.init_params(jax.random.key(0), rcfg)
    model = model_params_from_numpy(tcfg, jax.tree.map(np.asarray, params), "cpu")
    return (rengine.ServingEngine(rcfg, params, rengine.ServeConfig(max_len=128)),
            ServingEngine(tcfg, model, ServeConfig(max_len=128)))


def _prompts(shape, vocab=256, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def to_torch(f):
    a = np.asarray
    return fused_from_numpy(a(f.dense), a(f.learned.idx), a(f.learned.val),
                            a(f.lexical.idx), a(f.lexical.val), "cpu")


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


def test_greedy_generate_matches_repro(engines):
    reng, teng = engines
    prompts = _prompts((4, 8))
    want = np.asarray(reng.generate(jnp.asarray(prompts), 12))
    got = teng.generate(torch.as_tensor(prompts), 12)
    assert got.dtype == torch.int32 and got.shape == (4, 20)
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_matches_incremental_forward(engines):
    """Generation via the KV cache equals generation via repeated full
    forwards (tests/test_serving.py:41)."""
    _, teng = engines
    seq = torch.as_tensor(_prompts((2, 6), seed=2))
    out = teng.generate(seq, 5)
    fwd = tfm.make_forward(teng.cfg)
    with torch.no_grad():
        for _ in range(5):
            logits, _, _ = fwd(teng.params, seq)
            nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
            seq = torch.cat([seq, nxt[:, None]], dim=1)
    assert torch.equal(out, seq)


def test_generate_checks_max_len(engines):
    _, teng = engines
    with pytest.raises(ValueError, match="max_len"):
        teng.generate(torch.zeros((1, 120), dtype=torch.int32), 9)


def test_argmax_ties_go_to_first_index():
    logits = np.array([[1, 3, 3, 2, 3], [0, 0, 0, 0, 0], [5, 1, 5, 5, 2]], np.float32)
    want = np.asarray(jnp.argmax(jnp.asarray(logits), axis=-1))
    np.testing.assert_array_equal(want, [1, 0, 0])
    _, tcfg = _cfgs("naive")
    eng = ServingEngine(tcfg, None, ServeConfig())
    for dt in (torch.float32, torch.bfloat16):
        got = eng._sample(torch.as_tensor(logits).to(dt), None)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_temperature_sampling_shape_and_determinism():
    _, tcfg = _cfgs("naive")
    model = tfm.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    eng = ServingEngine(tcfg, model, ServeConfig(max_len=64, temperature=1.0))
    prompts = torch.as_tensor(_prompts((3, 5)))
    runs = [eng.generate(prompts, 10, generator=torch.Generator().manual_seed(s))
            for s in (7, 7, 8)]
    assert runs[0].shape == (3, 15) and torch.equal(runs[0][:, :5], prompts)
    assert bool(((runs[0] >= 0) & (runs[0] < tcfg.vocab)).all())
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])


# ---------------------------------------------------------------------------
# the RAG pipeline
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def rag_setup():
    corpus = make_corpus(CorpusConfig(n_docs=384, n_queries=8, n_topics=12, d_dense=32,
                                      nnz_sparse=12, nnz_lexical=8, seed=9))
    rindex = r_build_index(jax.tree.map(jnp.asarray, corpus.docs), R_BUILD)
    doc_tokens = np.random.default_rng(0).integers(0, 256, (384, 8)).astype(np.int32)
    return corpus, rindex, index_from_arrays(rindex, "cpu"), doc_tokens


def _pipelines(engines, rag_setup, service: bool):
    reng, teng = engines
    corpus, rindex, tindex, doc_tokens = rag_setup
    rcfg = rrag.RagConfig(top_k=2, ctx_tokens_per_doc=8, search=RSearchParams(**SEARCH))
    tcfg = RagConfig(top_k=2, ctx_tokens_per_doc=8, search=SearchParams(**SEARCH))
    rkw, tkw = {}, {}
    if service:
        batch = dict(flush_size=8, max_batch=8)
        rkw["service"] = rsvc.HybridSearchService(
            rindex, dataclasses.replace(rcfg.search, k=rcfg.top_k),
            rsvc.ServiceConfig(batcher=rbatcher.BatcherConfig(**batch)))
        tkw["service"] = HybridSearchService(
            tindex, dataclasses.replace(tcfg.search, k=tcfg.top_k),
            ServiceConfig(batcher=BatcherConfig(**batch)))
    return (rrag.RagPipeline(reng, rindex, jnp.asarray(doc_tokens), rcfg, **rkw),
            RagPipeline(teng, tindex, torch.as_tensor(doc_tokens), tcfg, **tkw))


@pytest.mark.parametrize("service", [False, True], ids=["direct", "service"])
def test_rag_answer_matches_repro(engines, rag_setup, service):
    corpus = rag_setup[0]
    rpipe, tpipe = _pipelines(engines, rag_setup, service)
    prompts = _prompts((8, 4), seed=3)
    want_out, want_res = rpipe.answer(corpus.queries, jnp.asarray(prompts), 6)
    trace = TraceContext("rag")
    got_out, got_res = tpipe.answer(to_torch(corpus.queries), torch.as_tensor(prompts), 6,
                                    trace=trace)
    assert got_out.shape == (8, 2 * 8 + 4 + 6)
    np.testing.assert_array_equal(got_res.ids[:, :2].numpy(), np.asarray(want_res.ids)[:, :2])
    np.testing.assert_array_equal(got_out.numpy(), np.asarray(want_out))
    names = set(trace.span_names())
    assert {"context_assembly", "generation", "prefill", "decode"} <= names
    assert ("retrieval" in names) != service  # the service records its own phases


def test_build_context_clips_pad_to_doc_zero(engines, rag_setup):
    _, tpipe = _pipelines(engines, rag_setup, False)
    res = dataclasses.make_dataclass("R", ["ids"])(torch.tensor([[3, -1], [-1, 383]]))
    ctx = tpipe.build_context(res)
    doc = tpipe.doc_tokens
    assert torch.equal(ctx, torch.stack([torch.cat([doc[3], doc[0]]),
                                         torch.cat([doc[0], doc[383]])]))


def test_rag_refuses_what_is_not_ported_or_disagrees(engines, rag_setup):
    _, teng = engines
    _, _, tindex, doc_tokens = rag_setup
    cfg = RagConfig(top_k=2, search=SearchParams(**SEARCH))
    pipe = RagPipeline(teng, tindex, torch.as_tensor(doc_tokens), cfg)
    with pytest.raises(ValueError, match="IngestPipeline"):
        pipe.retrieve_text(["a query"])
    with pytest.raises(ValueError, match="IngestPipeline"):
        pipe.answer_text(["a query"], torch.zeros((1, 2), dtype=torch.int32), 2)
    with pytest.raises(ValueError, match="FITTED"):
        RagPipeline(teng, tindex, torch.as_tensor(doc_tokens), cfg,
                    ingest=IngestPipeline(IngestConfig(), device="cpu"))
    other = HybridSearchService(tindex, SearchParams(k=2, iters=7))
    with pytest.raises(ValueError, match="disagree"):
        RagPipeline(teng, tindex, torch.as_tensor(doc_tokens), cfg, service=other)
    small = HybridSearchService(tindex, dataclasses.replace(cfg.search, k=1))
    with pytest.raises(ValueError, match="exceeds the service cap"):
        RagPipeline(teng, tindex, torch.as_tensor(doc_tokens), cfg, service=small)


@pytest.fixture(scope="module")
def text_setup():
    """The bundled corpus fitted by repro, built with its KG, carried across
    (index and fitted pipeline)."""
    corpus = load_bundled_corpus()
    rpipe = RIngestPipeline(RIngestConfig(d_dense=32))
    rindex = rpipe.build(rpipe.fit(corpus.texts), R_BUILD, key=jax.random.key(4))
    doc_tokens = np.random.default_rng(5).integers(0, 256, (corpus.n_docs, 8)).astype(np.int32)
    return (corpus, rpipe, rindex, ingest_pipeline_from_arrays(rpipe, "cpu"),
            index_from_arrays(rindex, "cpu"), doc_tokens)


TEXT_SEARCH = dict(k=5, iters=24, pool_size=48, use_keywords=True, use_kg=True)


@pytest.mark.parametrize("adaptive", [False, True], ids=["fixed", "adaptive"])
@pytest.mark.parametrize("service", [False, True], ids=["direct", "service"])
def test_text_entry_points_match_repro(engines, text_setup, service, adaptive):
    reng, teng = engines
    corpus, rpipe, rindex, tpipe, tindex, doc_tokens = text_setup
    rcfg = rrag.RagConfig(top_k=2, ctx_tokens_per_doc=8, adaptive=adaptive,
                          search=RSearchParams(**TEXT_SEARCH))
    tcfg = RagConfig(top_k=2, ctx_tokens_per_doc=8, adaptive=adaptive,
                     search=SearchParams(**TEXT_SEARCH))
    rkw, tkw = {}, {}
    if service:
        batch = dict(flush_size=8, max_batch=8)
        rkw["service"] = rsvc.HybridSearchService(
            rindex, dataclasses.replace(rcfg.search, k=2),
            rsvc.ServiceConfig(batcher=rbatcher.BatcherConfig(**batch)))
        tkw["service"] = HybridSearchService(tindex, dataclasses.replace(tcfg.search, k=2),
                                             ServiceConfig(batcher=BatcherConfig(**batch)))
    r = rrag.RagPipeline(reng, rindex, jnp.asarray(doc_tokens), rcfg, ingest=rpipe, **rkw)
    t = RagPipeline(teng, tindex, torch.as_tensor(doc_tokens), tcfg, ingest=tpipe, **tkw)
    texts = corpus.query_texts[:6] + ['"scurvy" on the voyage home with Magellan',
                                      '"rye" "starter" sourdough']
    enc = tpipe.encode_queries(texts)
    assert (enc.entities >= 0).any() and ((enc.keywords >= 0).sum(1) >= 2).any()
    trace = TraceContext("rag")
    got = t.retrieve_text(texts, trace=trace)
    want = r.retrieve_text(texts)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=1e-4,
                               atol=1e-4)
    assert "query_encode" in trace.span_names()
    prompts = _prompts((len(texts), 4), seed=6)
    got_out, _ = t.answer_text(texts, torch.as_tensor(prompts), 5)
    want_out, _ = r.answer_text(texts, jnp.asarray(prompts), 5)
    np.testing.assert_array_equal(got_out.numpy(), np.asarray(want_out))
    if not adaptive:  # the fixed spec: retrieve_text is retrieve over encode_queries
        direct = t.retrieve(enc.vectors, keywords=enc.keywords, entities=enc.entities)
        assert torch.equal(direct.ids, got.ids)


# ---------------------------------------------------------------------------
# the launcher and the default device
# ---------------------------------------------------------------------------


def test_serve_cli_rag_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH, "--smoke", "--rag",
         "--device", "cpu", "--requests", "4", "--gen", "4"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "RAG: retrieved top-2 per request; 4 requests" in out.stdout
    assert "generated 16 tokens" in out.stdout


def test_entry_points_default_to_cuda():
    """Without a card the default device raises; nothing falls back."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    from repro_torch.launch import serve

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--arch", ARCH, "--smoke"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tfm.init_params(get_smoke_config(ARCH), torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        model_params_from_numpy(get_smoke_config(ARCH), {}, None)
