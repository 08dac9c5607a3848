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


def _topk_case(seed, b, c, n=600, dd=64, pad=0.2, quant=False):
    """Queries, corpus, ids with an all-PAD row, a row with three live ids, a
    row of one repeated id and a row repeating an id at even positions (bias
    zero on the tie rows)."""
    from repro_torch.core.usms import quantize_corpus

    rng = np.random.default_rng(seed)
    q, corpus = _fused(rng, b, dd=dd, ps=7, pf=4), _fused(rng, n, dd=dd)
    ids = rng.integers(0, n, size=(b, c)).astype(np.int32)
    ids[rng.random(ids.shape) < pad] = -1
    ids[0] = -1
    ids[1] = -1
    ids[1, :3] = [11, 22, 33]
    ids[2] = 17
    ids[3, ::2] = 29
    bias = rng.normal(size=ids.shape).astype(np.float32)
    bias[2:4] = 0.0
    if quant:
        corpus = quantize_corpus(corpus)
    return q, corpus, torch.as_tensor(ids), torch.as_tensor(bias)


def _check_topk(got, want, k, c):
    """Scores to TOL, the same empty slots, positions equal except across
    ties, the edge rows of _topk_case exact."""
    gs, gp = (t.cpu() for t in got)
    ws, wp = want
    np.testing.assert_allclose(gs.numpy(), ws.numpy(), rtol=1e-5, atol=TOL)
    assert torch.equal(gp < 0, wp < 0)
    assert bool(((gs - ws).abs()[gp != wp] <= TOL).all())
    assert bool((gp[0] == -1).all()) and bool((gs[0] == -1e30).all())
    live = min(k, 3)
    assert bool((gp[1, :live] >= 0).all()) and bool((gp[1, live:] == -1).all())
    n = min(k, c)  # row 2: one id everywhere, so the lowest positions first
    assert torch.equal(gp[2, :n], torch.arange(n, dtype=torch.int32))
    assert bool((gp[2, n:] == -1).all())
    tied = gp[3][gp[3] % 2 == 0]
    assert torch.equal(tied, torch.sort(tied).values)


TOPK_CASES = [  # (B, C, k, corpus rows)
    (12, 72, 10, 600),  # one key a lane
    (12, 72, 24, 10_000),  # three tiles of the ordered form's scan
    (12, 100, 64, 600),  # two keys a lane
    (12, 100, 80, 600),  # k > 64: the arg-max rounds
    (9, 30, 40, 600),  # k > C
    (10, 33, 33, 600),  # k = C
    (300, 40, 16, 600),  # B > 264: 4 warps a one-pass block
]


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("ordered", [False, True], ids=["one_pass", "ordered"])
@pytest.mark.parametrize("case", TOPK_CASES)
def test_fused_topk_both_forms_match_plain(cuda, monkeypatch, case, ordered, quant):
    """Both forms of the kernel against the plain version at small sizes, the
    ordered form forced by the path constant."""
    from repro_torch.kernels import fused_topk as ft

    b, c, k, n = case
    q, corpus, ids, bias = _topk_case(sum(case), b, c, n=n, quant=quant)
    monkeypatch.setattr(ft, "ORDERED_MIN_PAIRS", 0 if ordered else 2**62)
    wrap, plain = ((ft.fused_topk_int8, ft.fused_topk_int8_plain) if quant
                   else (ft.fused_topk, ft.fused_topk_plain))
    for bias_t in (None, bias):
        want = plain(q, corpus, ids, k, bias_t)
        before = wrap.launches
        got = wrap(q.to(cuda), corpus.to(cuda), ids.to(cuda), k,
                   None if bias_t is None else bias_t.to(cuda))
        torch.cuda.synchronize()
        assert wrap.launches == before + 1
        _check_topk(got, want, k, c)


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("shape", [(2048, 152, 12), (2048, 12, 12), (32, 24, 24), (32, 24, 16),
                                   (1024, 16, 16), (2048, 1032, 32)],
                         ids=["refine_round", "refine_init", "serve_round", "serve_twin",
                              "search_round", "descent_chunk"])
def test_fused_topk_main_path_shapes(cuda, shape, quant):
    """The refinement, served, search and descent shapes (B, C, k) as the
    wrapper routes them (the descent chunk ordered, the rest in one pass), at
    Dd 1024 over 2^14 rows."""
    from repro_torch.kernels import fused_topk as ft

    b, c, k = shape
    q, corpus, ids, bias = _topk_case(b + c + k, b, c, n=2**14, dd=1024, quant=quant)
    wrap, plain = ((ft.fused_topk_int8, ft.fused_topk_int8_plain) if quant
                   else (ft.fused_topk, ft.fused_topk_plain))
    qc, cc, ic, bc = q.to(cuda), corpus.to(cuda), ids.to(cuda), bias.to(cuda)
    rows = slice(0, min(b, 64))  # the plain version on the CPU: the first rows
    want = plain(q[rows], corpus, ids[rows].contiguous(), k, bias[rows].contiguous())
    got = wrap(qc, cc, ic, k, bc)
    _check_topk([t[rows] for t in got], want, k, c)


@pytest.mark.parametrize("ordered", [False, True], ids=["one_pass", "ordered"])
def test_fused_topk_is_deterministic(cuda, monkeypatch, ordered):
    """Two launches give bit-identical scores and positions in either form
    (the counting sort orders the pairs of one id by atomics, but each score
    is one warp's fixed-order sum)."""
    from repro_torch.kernels import fused_topk as ft

    q, corpus, ids, bias = _topk_case(5, 64, 200)
    monkeypatch.setattr(ft, "ORDERED_MIN_PAIRS", 0 if ordered else 2**62)
    args = (q.to(cuda), corpus.to(cuda), ids.to(cuda), 32, bias.to(cuda))
    a, b = ft.fused_topk(*args), ft.fused_topk(*args)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])



HD_CASES = [  # (B, C, corpus rows, Dd)
    (7, 1, 300, 64),  # the self-score / path-norm shape, few rows: split 1
    (40, 16, 300, 64),  # entry scoring: a query row's candidates over several warps
    (9, 80, 300, 64),  # the final re-score's C
    (600, 3, 5000, 1024),  # Dd 1024: every register word of the warp form
]


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("warp", [False, True], ids=["block_form", "warp_form"])
@pytest.mark.parametrize("case", HD_CASES)
def test_hybrid_distance_both_forms_match_plain(cuda, monkeypatch, case, warp, quant):
    """Both forms of the distance kernel, each forced by the shape constant,
    against the plain version: PAD and out-of-range ids at -inf, an all-PAD
    row, planted repeats; two launches bit-identical."""
    from repro_torch.core.usms import quantize_corpus
    from repro_torch.kernels import hybrid_distance as hd

    b, c, n, dd = case
    rng = np.random.default_rng(sum(case))
    q, corpus = _fused(rng, b, dd=dd, ps=7, pf=4), _fused(rng, n, dd=dd, ps=32, pf=16)
    ids = rng.integers(0, n, size=(b, c)).astype(np.int32)
    ids[rng.random(ids.shape) < 0.2] = -1
    ids[0] = -1
    ids[1, 0] = n  # out of range: never read, -inf
    if c > 2:
        ids[2, 1:] = ids[2, 0]
    if quant:
        corpus = quantize_corpus(corpus)
    tid = torch.as_tensor(ids)
    monkeypatch.setattr(hd, "SMALL_C_MAX", 2**30 if warp else 0)
    wrap, plain = ((hd.hybrid_distance_int8, hd.hybrid_distance_int8_plain) if quant
                   else (hd.hybrid_distance, hd.hybrid_distance_plain))
    qc, cc, ic = q.to(cuda), corpus.to(cuda), tid.to(cuda)
    assert hd.warp_form(qc, cc, c) == warp
    want = plain(q, corpus, tid.clamp(max=n - 1))
    want = torch.where((tid >= 0) & (tid < n), want, torch.full_like(want, float("-inf")))
    before = wrap.launches
    got = wrap(qc, cc, ic)
    again = wrap(qc, cc, ic)
    torch.cuda.synchronize()
    assert wrap.launches == before + 2
    assert torch.equal(got, again)
    got = got.cpu()
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    live = torch.isfinite(want)
    np.testing.assert_allclose(got[live].numpy(), want[live].numpy(), rtol=1e-5, atol=TOL)
    if c > 2:
        assert bool((got[2, 1:] == got[2, 0]).all())


@pytest.mark.parametrize("k", [1, 12, 32, 64])
# 16-byte copies; the main width; 4-byte copies and a ragged last stage
@pytest.mark.parametrize("dd", [64, 1024, 42])
def test_pairwise_tile_matches_plain(cuda, k, dd):
    """The pair tiles against the plain version at every K class, with
    planted identical rows (identical output rows, bit for bit), an all-PAD
    ELL row and a row repeated across nodes; two launches bit-identical."""
    from repro_torch.kernels.pairwise_tile import pairwise_tile, pairwise_tile_plain

    rng = np.random.default_rng(k + dd)
    n = 400
    corpus = _fused(rng, n, dd=dd, ps=32, pf=16)
    corpus.learned.idx[3] = -1  # an all-PAD row on both paths
    corpus.learned.val[3] = 0.0
    corpus.lexical.idx[3] = -1
    corpus.lexical.val[3] = 0.0
    nodes = 300  # more nodes than some grids hold: blocks walk several
    ids = rng.integers(0, n, size=(nodes, k)).astype(np.int32)
    ids[:, 0] = 3
    if k > 6:
        ids[0, 6] = ids[0, 5]
        ids[7, k - 1] = ids[7, 0]
    tid = torch.as_tensor(ids)
    want = pairwise_tile_plain(corpus, tid)
    cc, ic = corpus.to(cuda), tid.to(cuda)
    before = pairwise_tile.launches
    got, again = pairwise_tile(cc, ic), pairwise_tile(cc, ic)
    torch.cuda.synchronize()
    assert pairwise_tile.launches == before + 2
    assert torch.equal(got, again)
    got = got.cpu()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=TOL)
    if k > 6:
        assert torch.equal(got[0, 5], got[0, 6])
        assert torch.equal(got[7, 0], got[7, k - 1])


FLASH_CASES = [
    # (B, H, KV, L, S, dk, dv, causal)
    (2, 8, 2, 333, 333, 64, 64, True),  # L not a multiple of any tile, g = 4
    (3, 4, 4, 1, 1, 64, 64, True),  # L = 1, g = 1
    (2, 4, 2, 130, 130, 48, 32, True),  # dk != dv
    (1, 4, 4, 100, 300, 32, 32, False),  # non-causal, S > L
    (1, 2, 1, 70, 70, 192, 128, True),  # MLA's head dims: two column groups
]
# the bf16 tensor-core forward's head-dim classes, tiles and TMA's edges
FLASH_TC_CASES = [
    (2, 4, 2, 256, 256, 64, 64, True),  # whole 128-row blocks and 128-key tiles
    (1, 4, 2, 200, 200, 128, 128, True),  # class 128: 64-key tiles, two column blocks
    (1, 2, 1, 150, 150, 256, 256, True),  # class 256: four column blocks
    (1, 2, 1, 30, 500, 64, 64, False),  # non-causal, S >> L, a partial last tile
    (1, 4, 2, 70, 70, 20, 20, True),  # rows of 40 bytes: the wrapper's padded copy
]


@pytest.mark.parametrize("case", FLASH_CASES + FLASH_TC_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain(cuda, case, dtype):
    """Out and LSE against the plain version, with the tolerances of
    tests/test_flash_attention.py:40 (1e-5 fp32, 2e-2 bf16); q, k, v in the
    model's (B, L, H, d) memory, read by stride (bf16: the tensor-core
    route, fp32: the CUDA-core route)."""
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


def test_flash_fwd_bf16_is_deterministic_and_counts_one_launch(cuda):
    """Two bf16 forward launches give bit-identical out and LSE (every block
    owns its rows, no atomics), each call adds one launch, and a view whose
    start is not 16-byte aligned (TMA's rule) takes the wrapper's padded
    copy and the same kernel."""
    from repro_torch.kernels.flash_attention import flash_attention_fwd, flash_attention_plain

    rng = np.random.default_rng(11)
    make = lambda *shape: torch.as_tensor(rng.normal(size=shape).astype(np.float32)).to(
        device=cuda, dtype=torch.bfloat16)
    q, k, v = make(2, 333, 8, 64).transpose(1, 2), make(2, 333, 2, 64), make(2, 333, 2, 64)
    k, v = k.transpose(1, 2), v.transpose(1, 2)
    before = flash_attention_fwd.launches
    first = flash_attention_fwd(q, k, v, True)
    again = flash_attention_fwd(q, k, v, True)
    torch.cuda.synchronize()
    assert flash_attention_fwd.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    shifted = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda)[1:].view(2, 8, 333, 64)
    shifted.copy_(q)
    assert shifted.data_ptr() % 16 != 0
    got = flash_attention_fwd(shifted, k, v, True)
    want = flash_attention_plain(q, k, v, True, 64**-0.5)
    torch.cuda.synchronize()
    assert flash_attention_fwd.launches == before + 3
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.float().cpu().numpy(), w.float().cpu().numpy(),
                                   rtol=2e-2, atol=2e-2)


BWD_CASES = FLASH_CASES + [
    (2, 8, 8, 96, 96, 64, 64, True),  # g = 1
    (1, 4, 2, 70, 70, 20, 20, True),  # bf16 rows of 40 bytes: 8-byte copies, padded to 32
    (1, 4, 2, 70, 70, 16, 16, True),  # one mma depth
    (1, 4, 2, 130, 130, 128, 128, True),  # the widest head dims one warp holds
    (2, 4, 2, 64, 64, 64, 64, True),  # exactly one tile
    (1, 2, 1, 30, 500, 64, 64, False),  # non-causal, S >> L
]


@pytest.mark.parametrize("case", BWD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_kernels_match_plain(cuda, case, dtype):
    """dQ, dK and dV of the two backward kernels (bf16: the tensor-core
    route; fp32: the CUDA-core route) against the plain version on the same
    (out, lse, dout); q, k, v in the model's (B, L, H, d) memory and dout
    with strides of its own. fp32 at 2e-4 (the gradient tolerance of
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_wrappers_take_strided_stats(cuda, dtype):
    """The per-kernel wrappers on views: every other query head (strided q,
    dout, LSE and Delta) against the plain version, so the LSE and Delta
    copies the wrappers make live until their kernels are enqueued; in
    both routes, at the tolerances of test_flash_bwd_kernels_match_plain."""
    from repro_torch.kernels.flash_attention import (
        _bwd_plain,
        _delta,
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
        flash_attention_fwd,
    )

    rng = np.random.default_rng(5)
    make = lambda *shape: torch.as_tensor(rng.normal(size=shape).astype(np.float32)).to(
        device=cuda, dtype=dtype)
    q, k, v = (make(2, n, h, 64).transpose(1, 2) for n, h in ((130, 8), (130, 2), (130, 2)))
    dout = make(2, 8, 130, 64)
    out, lse = flash_attention_fwd(q, k, v, True)
    delta = _delta(out, dout)
    views = (q[:, ::2], k, v, dout[:, ::2], lse[:, ::2], delta[:, ::2])
    want = _bwd_plain(*views, True, 64**-0.5)
    got = (flash_attention_bwd_dq(*views, True),) + flash_attention_bwd_dkv(*views, True)
    torch.cuda.synchronize()
    rtol = 2e-4 if dtype == torch.float32 else 2.0**-7
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.float().cpu().numpy(), w.float().cpu().numpy(), rtol=rtol,
                                   atol=2e-4, err_msg=name)


def test_flash_bwd_bf16_is_deterministic(cuda):
    """Two launches of the bf16 backward at one shape give bit-identical
    dQ, dK and dV: every block owns its output rows, no atomics."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd, flash_attention_fwd

    rng = np.random.default_rng(7)
    make = lambda *shape: torch.as_tensor(rng.normal(size=shape).astype(np.float32)).to(
        device=cuda, dtype=torch.bfloat16)
    q, k, v = make(2, 8, 333, 64), make(2, 2, 333, 64), make(2, 2, 333, 64)
    dout = make(2, 8, 333, 64)
    out, lse = flash_attention_fwd(q, k, v, True)
    first = flash_attention_bwd(q, k, v, out, lse, dout, True)
    again = flash_attention_bwd(q, k, v, out, lse, dout, True)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), first, again):
        assert torch.equal(a, b), name


# ---------------------------------------------------------------------------
# the write path: insert and router compaction through the kernels against
# the same operations through the plain versions
# ---------------------------------------------------------------------------


def _write_cfgs():
    from repro_torch.core.index import BuildConfig
    from repro_torch.core.knn_graph import KnnConfig
    from repro_torch.core.pruning import PruneConfig

    kern = BuildConfig(knn=KnnConfig(k=16, iters=3), prune=PruneConfig(degree=12,
                       keyword_degree=4), path_refine_iters=1)
    plain = dataclasses.replace(
        kern, knn=dataclasses.replace(kern.knn, use_kernel=False),
        prune=dataclasses.replace(kern.prune, use_kernel=False))
    return kern, plain


def _row_sets_equal(a, b) -> float:
    sa = torch.sort(a.masked_fill(a < 0, 2**30), dim=-1).values
    sb = torch.sort(b.masked_fill(b < 0, 2**30), dim=-1).values
    return float((sa == sb).all(dim=-1).float().mean().item())


def test_insert_kernels_match_plain_versions(cuda):
    from repro_torch.core import build_pipeline as bp
    from repro_torch.data.corpus import CorpusConfig, make_corpus
    from repro_torch.kernels.fused_topk import fused_topk
    from repro_torch.kernels.pairwise_tile import pairwise_tile

    c = make_corpus(CorpusConfig(n_docs=640, n_queries=8, n_topics=16, d_dense=64, seed=2))
    kern, plain = _write_cfgs()
    base = bp.build_index(c.docs[:512], kern, generator=torch.Generator("cuda").manual_seed(1))
    launched = fused_topk.launches, pairwise_tile.launches
    got = bp.insert(base, c.docs[512:], kern, generator=torch.Generator("cuda").manual_seed(2))
    assert fused_topk.launches > launched[0] and pairwise_tile.launches > launched[1]
    want = bp.insert(base, c.docs[512:], plain,
                     generator=torch.Generator("cuda").manual_seed(2))
    assert _row_sets_equal(got.semantic_edges, want.semantic_edges) >= 0.99
    assert _row_sets_equal(got.keyword_edges, want.keyword_edges) >= 0.99
    torch.testing.assert_close(got.self_ip, want.self_ip, rtol=0, atol=TOL)
    assert torch.equal(got.alive, want.alive) and got.n == 640


def test_router_compaction_kernels_match_plain_versions(cuda):
    from repro_torch.core.fusion import FusionSpec
    from repro_torch.core.search import SearchParams
    from repro_torch.core.segment_pool import SegmentPool, build_pool_segment
    from repro_torch.data.corpus import CorpusConfig, make_corpus
    from repro_torch.serving.hybrid_service import HybridSearchService
    from repro_torch.serving.segment_router import RouterConfig, SegmentRouter

    c = make_corpus(CorpusConfig(n_docs=768, n_queries=16, n_topics=16, d_dense=64, seed=4))
    kern, plain = _write_cfgs()
    seg = build_pool_segment(c.docs[:512], np.arange(512), kern,
                             generator=torch.Generator("cuda").manual_seed(3))
    out = []
    for cfg, use in ((kern, None), (plain, False)):
        svc = HybridSearchService(SegmentPool.from_segmented(seg),
                                  SearchParams(k=8, use_kernel=use, corpus_dtype="int8"))
        router = SegmentRouter(svc, cfg, RouterConfig(seal_threshold=10**9))
        svc.insert(c.docs[512:640])
        svc.mark_deleted([3, 515])
        svc.insert(c.docs[640:768])
        router.compact_incremental()
        out.append((svc, svc.search(c.queries, FusionSpec.three_path())))
    (sk, rk), (sp, rp) = out
    gk, gp = sk.index.groups[-1], sp.index.groups[-1]
    assert torch.equal(gk.global_ids, gp.global_ids)
    assert type(gk.index.corpus).__name__ == "QuantizedFusedVectors"
    assert _row_sets_equal(gk.index.semantic_edges, gp.index.semantic_edges) >= 0.99
    same = rk.ids == rp.ids
    assert same.float().mean() >= 0.95
    torch.testing.assert_close(rk.scores[same], rp.scores[same], rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# the text path and the replica tier: text encoded onto the card, a tier of
# two replicas through the kernels against the same tier through the plain
# versions
# ---------------------------------------------------------------------------


def test_text_tier_kernels_match_plain_versions(cuda):
    from repro_torch.core.fusion import FusionSpec
    from repro_torch.core.search import SearchParams
    from repro_torch.core.segment_pool import SegmentPool, build_pool_segment
    from repro_torch.data.syncorpus import SynCorpus, SynCorpusConfig
    from repro_torch.ingest import IngestConfig, IngestPipeline, adaptive_fusion_for
    from repro_torch.kernels.fused_topk import fused_topk
    from repro_torch.serving.hybrid_service import HybridSearchService
    from repro_torch.serving.replica_router import (
        Replica,
        ReplicaRouter,
        ReplicaTierConfig,
        build_ring,
        ring_homes,
    )

    gen = SynCorpus(SynCorpusConfig(n_docs=640, n_topics=16, n_entities=48, n_queries=16,
                                    seed=2))
    pipe = IngestPipeline(IngestConfig(d_dense=64))  # the card by default
    fit = pipe.fit(gen.fit_sample(256))
    docs, ents = pipe.encode_docs(gen.texts(0, 640))
    assert docs.dense.is_cuda and pipe.n_triplets > 0
    kg = dict(kg_triplets=fit.kg.triplets, n_entities=fit.kg.n_entities)
    homes = ring_homes(build_ring(["replica0", "replica1"], 64), np.arange(640))
    enc = pipe.encode_queries([q.text for q in gen.queries()])
    kern, plain = _write_cfgs()
    out = []
    for cfg, use in ((kern, None), (plain, False)):
        reps = []
        for i in range(2):
            rows = np.flatnonzero(homes == i)
            seg = build_pool_segment(docs.take(torch.as_tensor(rows, device="cuda")), rows, cfg,
                                     doc_entities=ents[rows],
                                     generator=torch.Generator("cuda").manual_seed(i), **kg)
            svc = HybridSearchService(SegmentPool.from_segmented(seg),
                                      SearchParams(k=8, use_kg=True, use_kernel=use))
            reps.append(Replica(svc, name=f"replica{i}"))
        tier = ReplicaRouter(reps, ReplicaTierConfig())
        launched = fused_topk.launches
        spec = adaptive_fusion_for(enc, stats=tier.path_stats())
        out.append(tier.search(enc.vectors, spec, entities=enc.entities))
        assert (fused_topk.launches > launched) == (use is None)
        tier.close()
    rk, rp = out
    same = rk.ids == rp.ids
    assert same.float().mean() >= 0.95
    torch.testing.assert_close(rk.scores[same], rp.scores[same], rtol=TOL, atol=TOL)


def test_a_program_span_contains_its_kernel_on_the_profilers_clock(cuda):
    """A span of the program's tracer, put on CLOCK_REALTIME by its context's
    time pair, holds the device interval of the kernel launched and
    synchronised inside it, as ``torch.profiler`` records it: the port's
    distance kernel, then a warm add twenty times. A kernel starts a launch
    latency after the span opens (tens of us under the profiler), so
    containment alone would pass a pair that placed spans that much too
    early. Each add's span therefore ends with a synchronise and is followed
    by one, both recorded on the kernels' clock: of the twenty spans, the
    least gap from the last synchronise's return to the span's end bounds how
    late the pair may place a span, and the least gap from the span's start
    to its first synchronise, or from its end to the next synchronise, how
    early. Each least gap is at most 20 us and none is below -2 us: the pair
    places a span within 20 us of the profiler's own record of the work
    inside it, on either side."""
    import time

    from torch.profiler import ProfilerActivity, profile

    from repro_torch import obs
    from repro_torch.kernels.hybrid_distance import hybrid_distance

    def spin(seconds):  # a pause that keeps the core awake, unlike sleep
        t = time.perf_counter()
        while time.perf_counter() - t < seconds:
            pass

    rng = np.random.default_rng(5)
    q = _fused(rng, 512).to(cuda)
    corpus = _fused(rng, 4096).to(cuda)
    ids = torch.as_tensor(rng.integers(0, 4096, size=(512, 96)).astype(np.int32), device=cuda)
    x = torch.zeros(1 << 20, device=cuda)
    hybrid_distance(q, corpus, ids)  # built and warm
    torch.cuda.synchronize()
    reps = 20
    ctx = obs.TraceContext("clock")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof, \
            obs.tracing(ctx):
        torch.cuda.synchronize()
        spin(0.002)
        with obs.span("distance") as distance:
            hybrid_distance(q, corpus, ids)
            torch.cuda.synchronize()
        x.add_(1.0)  # the add's first launch under the profiler
        torch.cuda.synchronize()
        adds = []
        for _ in range(reps):
            spin(0.001)
            with obs.span("add") as add:
                torch.cuda.synchronize()
                x.add_(1.0)
                torch.cuda.synchronize()
            torch.cuda.synchronize()
            adds.append(add)
        spin(0.002)
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    events = sorted((start_ns + round(e.time_range.start * 1e3),
                     start_ns + round(e.time_range.end * 1e3), e.name, e.device_type)
                    for e in prof.events())
    dev = torch.autograd.DeviceType.CUDA
    ops = [e[:3] for e in events if e[3] == dev]
    syncs = [e[:2] for e in events if e[3] != dev and "DeviceSynchronize" in e[2]]
    assert [n for *_, n in ops if "hybrid_distance" in n] and len(ops) == 2 + reps, ops
    slack = 2_000  # ns: the pair's reads, and the float seconds of a span
    for span, (k0, k1, name) in zip([distance] + adds, [ops[0]] + ops[2:]):
        s0, s1 = ctx.unix_ns(span.t0), ctx.unix_ns(span.t1)
        assert s0 - slack <= k0 <= k1 <= s1 + slack, (span.name, s0, k0, k1, s1)
    leads, tails, after = [], [], []
    for add in adds:
        s0, s1 = ctx.unix_ns(add.t0), ctx.unix_ns(add.t1)
        near = [(a, b) for a, b in syncs if s0 - 400_000 <= a <= s1 + 400_000]
        assert len(near) == 3, (s0, s1, near)
        leads.append(near[0][0] - s0)
        tails.append(s1 - near[1][1])
        after.append(near[2][0] - s1)
    print(f"span start to its first synchronise: {[round(v / 1e3, 3) for v in leads]} us")
    print(f"last synchronise's return to span end: {[round(v / 1e3, 3) for v in tails]} us")
    print(f"span end to the next synchronise: {[round(v / 1e3, 3) for v in after]} us")
    assert min(leads + tails + after) >= -slack, (leads, tails, after)
    assert min(tails) <= 20_000 and min(leads + after) <= 20_000, (leads, tails, after)
