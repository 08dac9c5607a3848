"""The port's CUDA kernels (fp32 and int8 storage, flash attention) against
their plain PyTorch versions, on a CUDA card. Imports neither jax nor repro, so it runs
where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Without a card every test skips (the kernels have no CPU mode).
chip_smoke.py phase 2 makes the same checks at the main path's shapes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.usms import FusedVectors, SparseVec  # noqa: E402

pytestmark = pytest.mark.gpu
TOL = 1e-4  # fp32 sums in another order than the plain version


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _ell(rng, rows, cap, vocab):
    idx = np.full((rows, cap), -1, np.int32)
    val = np.zeros((rows, cap), np.float32)
    for r in range(rows):
        k = rng.integers(0, cap + 1)
        idx[r, :k] = rng.choice(vocab, size=k, replace=False)
        val[r, :k] = rng.uniform(0.1, 1.5, size=k)
    return SparseVec(torch.as_tensor(idx), torch.as_tensor(val))


def _fused(rng, rows, dd=64, ps=12, pf=6):
    dense = torch.as_tensor(rng.normal(size=(rows, dd)).astype(np.float32))
    return FusedVectors(dense, _ell(rng, rows, ps, 97), _ell(rng, rows, pf, 31))


def test_kernels_match_plain_versions(cuda):
    from repro_torch.kernels.fused_topk import fused_topk
    from repro_torch.kernels.hybrid_distance import hybrid_distance
    from repro_torch.kernels.pairwise_tile import pairwise_tile

    rng = np.random.default_rng(0)
    q, corpus = _fused(rng, 8, ps=7, pf=4), _fused(rng, 300)
    ids = rng.integers(0, 300, size=(8, 50)).astype(np.int32)
    ids[rng.random(ids.shape) < 0.2] = -1
    ids[0] = -1  # all PAD
    ids[1] = 17  # planted ties
    bias = rng.normal(size=ids.shape).astype(np.float32)
    bias[1] = 0.0
    tid, tb = torch.as_tensor(ids), torch.as_tensor(bias)
    qc, cc = q.to(cuda), corpus.to(cuda)

    want = hybrid_distance(q, corpus, tid)
    got = hybrid_distance(qc, cc, tid.to(cuda)).cpu()
    assert torch.equal(torch.isinf(got), tid < 0)
    live = tid >= 0
    np.testing.assert_allclose(got[live].numpy(), want[live].numpy(), rtol=1e-5, atol=TOL)

    ws, wp = fused_topk(q, corpus, tid, 10, tb)
    gs, gp = (t.cpu() for t in fused_topk(qc, cc, tid.to(cuda), 10, tb.to(cuda)))
    np.testing.assert_allclose(gs.numpy(), ws.numpy(), rtol=1e-5, atol=TOL)
    assert torch.equal(gp < 0, wp < 0)
    flip = gp != wp
    assert bool(((gs - ws).abs()[flip] <= TOL).all())
    assert bool((gp[0] == -1).all())
    assert torch.equal(gp[1], torch.arange(10, dtype=torch.int32))

    pid = tid.clamp(min=0)[:, :16].contiguous()
    np.testing.assert_allclose(pairwise_tile(cc, pid.to(cuda)).cpu().numpy(),
                               pairwise_tile(corpus, pid).numpy(), rtol=1e-5, atol=TOL)


def test_kernel_build_and_search_match_plain(cuda):
    from repro_torch.core.build_pipeline import build_index
    from repro_torch.core.fusion import FusionSpec
    from repro_torch.core.index import BuildConfig
    from repro_torch.core.knn_graph import KnnConfig
    from repro_torch.core.pruning import PruneConfig
    from repro_torch.core.search import SearchParams, search
    from repro_torch.data.corpus import CorpusConfig, make_corpus

    c = make_corpus(CorpusConfig(n_docs=1024, n_queries=32, n_topics=16, d_dense=64, seed=2))
    cfg = BuildConfig(knn=KnnConfig(k=16, iters=4, node_chunk=512),
                      prune=PruneConfig(degree=12, keyword_degree=6, node_chunk=256))
    plain = dataclasses.replace(
        cfg, knn=dataclasses.replace(cfg.knn, use_kernel=False),
        prune=dataclasses.replace(cfg.prune, use_kernel=False))
    gen = lambda: torch.Generator(device=cuda).manual_seed(4)
    ik = build_index(c.docs, cfg, generator=gen())
    ip = build_index(c.docs, plain, generator=gen())
    same = [set(a[a >= 0].tolist()) == set(b[b >= 0].tolist())
            for a, b in zip(ik.semantic_edges.cpu().numpy(), ip.semantic_edges.cpu().numpy())]
    assert np.mean(same) >= 0.99
    params = SearchParams(use_keywords=True)
    rk = search(ik, c.queries, FusionSpec.three_path(), params, keywords=c.query_keywords)
    rp = search(ik, c.queries, FusionSpec.three_path(),
                dataclasses.replace(params, use_kernel=False), keywords=c.query_keywords)
    np.testing.assert_allclose(rk.scores.cpu().numpy(), rp.scores.cpu().numpy(), atol=TOL)
    assert (rk.ids != rp.ids).float().mean().item() <= 0.01


@pytest.mark.parametrize("dd", [64, 40])  # 16-byte int8 loads; the scalar path (40 % 16 != 0)
def test_int8_kernels_match_plain_versions(cuda, dd):
    from repro_torch.core.usms import quantize_corpus
    from repro_torch.kernels.fused_topk import fused_topk_int8
    from repro_torch.kernels.hybrid_distance import hybrid_distance_int8

    rng = np.random.default_rng(1)
    q, corpus = _fused(rng, 8, dd=dd, ps=7, pf=4), _fused(rng, 300, dd=dd)
    corpus.dense[5] = 0.0  # zero row: scale 1.0
    corpus.dense[6] = -1e4  # every value at -127
    cq = quantize_corpus(corpus)
    ids = rng.integers(0, 300, size=(8, 50)).astype(np.int32)
    ids[rng.random(ids.shape) < 0.2] = -1
    ids[0] = -1  # all PAD
    ids[1] = 17  # planted ties
    ids[2, :2] = [5, 6]
    bias = rng.normal(size=ids.shape).astype(np.float32)
    bias[1] = 0.0
    tid, tb = torch.as_tensor(ids), torch.as_tensor(bias)
    qc, cc = q.to(cuda), cq.to(cuda)

    want = hybrid_distance_int8(q, cq, tid)
    got = hybrid_distance_int8(qc, cc, tid.to(cuda)).cpu()
    assert torch.equal(torch.isinf(got), tid < 0)
    live = tid >= 0
    np.testing.assert_allclose(got[live].numpy(), want[live].numpy(), rtol=1e-5, atol=TOL)

    for bias_t in (None, tb):
        ws, wp = fused_topk_int8(q, cq, tid, 10, bias_t)
        gs, gp = (t.cpu() for t in fused_topk_int8(
            qc, cc, tid.to(cuda), 10, None if bias_t is None else bias_t.to(cuda)))
        np.testing.assert_allclose(gs.numpy(), ws.numpy(), rtol=1e-5, atol=TOL)
        assert torch.equal(gp < 0, wp < 0)
        assert bool(((gs - ws).abs()[gp != wp] <= TOL).all())
        assert bool((gp[0] == -1).all())
        if bias_t is not None:
            assert torch.equal(gp[1], torch.arange(10, dtype=torch.int32))


def test_int8_pool_service_matches_plain(cuda):
    """A two-segment int8 pool served on the card through the kernels and
    through the plain versions gives the same results up to ties."""
    from repro_torch.core.fusion import FusionSpec
    from repro_torch.core.index import BuildConfig
    from repro_torch.core.knn_graph import KnnConfig
    from repro_torch.core.pruning import PruneConfig
    from repro_torch.core.search import SearchParams
    from repro_torch.core.segment_pool import SegmentPool, append_segment, build_pool_segment
    from repro_torch.data.corpus import CorpusConfig, make_corpus
    from repro_torch.kernels.fused_topk import fused_topk, fused_topk_int8
    from repro_torch.serving.hybrid_service import HybridSearchService

    c = make_corpus(CorpusConfig(n_docs=1024, n_queries=32, n_topics=16, d_dense=64, seed=2))
    cfg = BuildConfig(knn=KnnConfig(k=16, iters=4, node_chunk=512),
                      prune=PruneConfig(degree=12, keyword_degree=6, node_chunk=256))
    pool = SegmentPool(groups=[])
    for s in range(2):
        lo, hi = 512 * s, 512 * (s + 1)
        seg = build_pool_segment(c.docs[lo:hi], np.arange(lo, hi), cfg, corpus_dtype="int8",
                                 generator=torch.Generator(device=cuda).manual_seed(s))
        pool, _ = append_segment(pool, seg)
    params = SearchParams(use_keywords=True, corpus_dtype="int8")
    kw = c.query_keywords
    fused_topk.launches = fused_topk_int8.launches = 0
    rk = HybridSearchService(pool, params).search(c.queries, FusionSpec.rrf(), keywords=kw)
    assert fused_topk_int8.launches > 0 and fused_topk.launches == 0
    rp = HybridSearchService(pool, dataclasses.replace(params, use_kernel=False)).search(
        c.queries, FusionSpec.rrf(), keywords=kw)
    np.testing.assert_allclose(rk.scores.numpy(), rp.scores.numpy(), atol=TOL)
    assert (rk.ids != rp.ids).float().mean().item() <= 0.01


FLASH_CASES = [
    # (B, H, KV, L, S, dk, dv, causal)
    (2, 8, 2, 333, 333, 64, 64, True),  # L not a multiple of any tile, g = 4
    (3, 4, 4, 1, 1, 64, 64, True),  # L = 1, g = 1
    (2, 4, 2, 130, 130, 48, 32, True),  # dk != dv
    (1, 4, 4, 100, 300, 32, 32, False),  # non-causal, S > L
    (1, 2, 1, 70, 70, 192, 128, True),  # MLA's head dims: two column groups
]


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain(cuda, case, dtype):
    """Out and LSE against the plain version, with the tolerances of
    tests/test_flash_attention.py:40 (1e-5 fp32, 2e-2 bf16); q, k, v in the
    model's (B, L, H, d) memory, read by stride."""
    from repro_torch.kernels.flash_attention import flash_attention_fwd, flash_attention_plain

    b, h, kv, l, s, dk, dv, causal = case
    rng = np.random.default_rng(sum(case[:7]))
    make = lambda *shape: torch.as_tensor(rng.normal(size=shape).astype(np.float32)).to(dtype)
    q = make(b, l, h, dk).transpose(1, 2)
    k = make(b, s, kv, dk).transpose(1, 2)
    v = make(b, s, kv, dv).transpose(1, 2)
    want_out, want_lse = flash_attention_plain(q, k, v, causal, dk**-0.5)
    before = flash_attention_fwd.launches
    out, lse = flash_attention_fwd(q.to(cuda), k.to(cuda), v.to(cuda), causal)
    torch.cuda.synchronize()
    assert flash_attention_fwd.launches == before + 1
    assert out.dtype == dtype and out.shape == (b, h, l, dv) and lse.dtype == torch.float32
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    np.testing.assert_allclose(out.cpu().float().numpy(), want_out.float().numpy(),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(lse.cpu().numpy(), want_lse.numpy(), rtol=tol, atol=tol)


@pytest.mark.parametrize("case", FLASH_CASES + [(2, 8, 8, 96, 96, 64, 64, True)])  # + g = 1
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_kernels_match_plain(cuda, case, dtype):
    """dQ, dK and dV of the two backward kernels against the plain version
    on the same (out, lse, dout); q, k, v in the model's (B, L, H, d) memory
    and dout with strides of its own. fp32 at 2e-4 (the gradient tolerance of
    tests/test_flash_attention.py:64); bf16 within one bf16 ulp of each
    value (both sides sum in fp32 and round once) plus 2e-4 for the fp32
    cancellation in dP - Delta (exact zeros at L = 1)."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd,
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
        flash_attention_bwd_plain,
        flash_attention_fwd,
    )

    b, h, kv, l, s, dk, dv, causal = case
    rng = np.random.default_rng(sum(case[:7]) + 1)
    make = lambda *shape: torch.as_tensor(rng.normal(size=shape).astype(np.float32)).to(
        device=cuda, dtype=dtype)
    q = make(b, l, h, dk).transpose(1, 2)
    k = make(b, s, kv, dk).transpose(1, 2)
    v = make(b, s, kv, dv).transpose(1, 2)
    dout = make(l, b, h, dv).permute(1, 2, 0, 3)  # strides of its own, the last dim contiguous
    out, lse = flash_attention_fwd(q, k, v, causal)
    want = flash_attention_bwd_plain(q, k, v, out, lse, dout, causal, dk**-0.5)
    n_dq, n_dkv = flash_attention_bwd_dq.launches, flash_attention_bwd_dkv.launches
    got = flash_attention_bwd(q, k, v, out, lse, dout, causal)
    torch.cuda.synchronize()
    assert flash_attention_bwd_dq.launches == n_dq + 1
    assert flash_attention_bwd_dkv.launches == n_dkv + 1
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype and g.shape == w.shape, name
        g, w = g.float().cpu(), w.float().cpu()
        assert bool(torch.isfinite(g).all()), name
        rtol = 2e-4 if dtype == torch.float32 else 2.0**-7
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=rtol, atol=2e-4, err_msg=name)


def test_flash_bwd_wrappers_take_strided_stats(cuda):
    """The per-kernel wrappers on views: every other query head (strided q,
    dout, LSE and Delta) against the plain version, so the LSE and Delta
    copies the wrappers make live until their kernels are enqueued."""
    from repro_torch.kernels.flash_attention import (
        _bwd_plain,
        _delta,
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
        flash_attention_fwd,
    )

    rng = np.random.default_rng(5)
    make = lambda *shape: torch.as_tensor(rng.normal(size=shape).astype(np.float32)).to(cuda)
    q, k, v = (make(2, n, h, 64).transpose(1, 2) for n, h in ((130, 8), (130, 2), (130, 2)))
    dout = make(2, 8, 130, 64)
    out, lse = flash_attention_fwd(q, k, v, True)
    delta = _delta(out, dout)
    views = (q[:, ::2], k, v, dout[:, ::2], lse[:, ::2], delta[:, ::2])
    want = _bwd_plain(*views, True, 64**-0.5)
    got = (flash_attention_bwd_dq(*views, True),) + flash_attention_bwd_dkv(*views, True)
    torch.cuda.synchronize()
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), rtol=2e-4, atol=2e-4,
                                   err_msg=name)
