"""The port's int8 corpus storage (DESIGN.md §13) against repro's.

``quantize_corpus`` is held exactly (int8 rows equal, scales within 1 ulp,
fp16 values equal); the plain quant scores and fused top-k equal repro's
oracles and its Pallas ``has_scale`` kernels run in interpret mode (1e-4,
positions equal up to ties); and ``search`` under
``SearchParams(corpus_dtype="int8")`` on a repro-built index, quantized by
repro and carried across with ``convert.index_from_arrays``, gives repro's
ids up to ties and its scores to 1e-4 in all four fusion modes, with
keywords on and off.
"""

from __future__ import annotations

import dataclasses

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
from repro.core import usms as rusms  # noqa: E402
from repro.core.search import SearchParams as RSearchParams  # noqa: E402
from repro.core.search import search as r_search  # noqa: E402
from repro.core.usms import PAD_IDX  # noqa: E402
from repro.data.corpus import CorpusConfig, make_corpus  # noqa: E402
from repro.kernels import ops as rops  # noqa: E402
from repro.kernels import ref as rref  # noqa: E402
from repro_torch.convert import corpus_from_arrays, fused_from_numpy  # noqa: E402
from repro_torch.convert import index_from_arrays  # noqa: E402
from repro_torch.core import usms as tusms  # noqa: E402
from repro_torch.core.fusion import FusionSpec  # noqa: E402
from repro_torch.core.search import SearchParams, resolve_params, search  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.hybrid_distance import check_query_corpus  # noqa: E402
from tests.helpers import random_fused  # noqa: E402

TOL = 1e-4  # fp32 sums in another order than repro's
MODES = ("weighted_sum", "minmax", "zscore", "rrf")


def to_torch(f):
    a = np.asarray
    return fused_from_numpy(a(f.dense), a(f.learned.idx), a(f.learned.val),
                            a(f.lexical.idx), a(f.lexical.val), "cpu")


def to_jax(f):
    return jax.tree.map(jnp.asarray, f)


def both_quantized(f):
    """(repro's quantized corpus, the port's quantize_corpus of the same rows)."""
    return rusms.quantize_corpus(to_jax(f)), tusms.quantize_corpus(to_torch(f))


def assert_topk_match(got, want):
    gs, gi = (np.asarray(x) for x in got)
    ws, wi = (np.asarray(x) for x in want)
    np.testing.assert_allclose(gs, ws, rtol=TOL, atol=TOL)
    flip = gi != wi
    assert np.all(np.abs(gs - ws)[flip] <= TOL), f"positions diverged:\n{gi}\nvs\n{wi}"
    np.testing.assert_array_equal(gi < 0, wi < 0)


def _extreme_rows(rng, rows=10, dd=16):
    f = random_fused(rng, (rows,), d_dense=dd, ps=6, pf=4)
    dense = np.asarray(f.dense).copy()
    dense[0] = 0.0  # all-zero row: scale 1.0, all-zero int8
    dense[1] = 1e-30  # denormal-ish row
    dense[2] = -1e4  # large-magnitude row: every value at -127
    dense[3, ::2], dense[3, 1::2] = 2.5, -2.5  # alternating: +127 / -127
    dense[4] = np.linspace(-1, 1, dd)  # exact .5 steps round half to even
    return dataclasses.replace(f, dense=dense.astype(np.float32))


@pytest.mark.parametrize("seed", [11, 12])
def test_quantize_corpus_matches_repro(seed):
    rng = np.random.default_rng(seed)
    f = _extreme_rows(rng) if seed == 12 else random_fused(rng, (37,), d_dense=24, ps=10, pf=8)
    want, got = both_quantized(f)
    assert isinstance(got, tusms.QuantizedFusedVectors) and not hasattr(got, "dense")
    assert got.dense_q.dtype == torch.int8 and got.dense_scale.dtype == torch.float32
    np.testing.assert_array_equal(got.dense_q.numpy(), np.asarray(want.dense_q))
    ws, gs = np.asarray(want.dense_scale), got.dense_scale.numpy()
    assert np.all(np.abs(gs.view(np.int32) - ws.view(np.int32)) <= 1), "scales beyond 1 ulp"
    for path in ("learned", "lexical"):
        gv, wv = getattr(got, path), getattr(want, path)
        assert gv.val.dtype == torch.float16
        np.testing.assert_array_equal(gv.val.numpy(), np.asarray(wv.val))
        np.testing.assert_array_equal(gv.idx.numpy(), np.asarray(wv.idx))
    if seed == 12:
        dq = got.dense_q.numpy()
        assert gs[0] == 1.0 and np.all(dq[0] == 0)
        assert np.all(dq[2] == -127) and set(np.abs(dq[3]).tolist()) == {127}
    back_w = rusms.dequantize_corpus(want)
    back_g = tusms.dequantize_corpus(got)
    for g, w in zip(back_g.tensors(), (back_w.dense, back_w.learned.idx, back_w.learned.val,
                                       back_w.lexical.idx, back_w.lexical.val)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


def test_corpus_nbytes_quantized_matches_repro():
    rng = np.random.default_rng(13)
    f = random_fused(rng, (64,), d_dense=32, ps=8, pf=4)
    want, got = both_quantized(f)
    assert tusms.corpus_nbytes_by_leaf(got) == rusms.corpus_nbytes_by_leaf(want)
    assert sum(tusms.corpus_nbytes_by_leaf(got).values()) < sum(
        tusms.corpus_nbytes_by_leaf(to_torch(f)).values())


@pytest.mark.parametrize("repro_kernel", [False, True])
@pytest.mark.parametrize("b,c,dd", [(3, 130, 40), (2, 17, 32)])
def test_quant_hybrid_scores_matches_repro(b, c, dd, repro_kernel):
    rng = np.random.default_rng(b * 100 + c)
    q = random_fused(rng, (b,), d_dense=dd, ps=9, pf=5)
    cands = random_fused(rng, (b, c), d_dense=dd, ps=9, pf=5)
    want_c, got_c = both_quantized(cands)
    want = rops.hybrid_scores(to_jax(q), want_c, c_tile=64, use_kernel=repro_kernel,
                              interpret=repro_kernel)
    got = tops.hybrid_scores(to_torch(q), got_c)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(
        tref.hybrid_scores_quant_ref(to_torch(q), got_c).numpy(),
        np.asarray(rref.hybrid_scores_quant_ref(to_jax(q), want_c)), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("repro_kernel", [False, True])
@pytest.mark.parametrize("k,pad_frac,with_bias", [(10, 0.0, False), (5, 0.3, True),
                                                  (32, 0.5, True)])
def test_quant_fused_topk_matches_repro(k, pad_frac, with_bias, repro_kernel):
    rng = np.random.default_rng(22 + k)
    b, c = 2, 40
    q = random_fused(rng, (b,), d_dense=32, ps=8, pf=4)
    want_c, got_c = both_quantized(random_fused(rng, (b, c), d_dense=32, ps=8, pf=4))
    cid = rng.permutation(4096)[: b * c].reshape(b, c).astype(np.int32)
    cid[rng.random((b, c)) < pad_frac] = PAD_IDX
    bias = rng.normal(size=(b, c)).astype(np.float32) if with_bias else None
    want = rops.fused_topk(to_jax(q), want_c, jnp.asarray(cid), k,
                           bias=None if bias is None else jnp.asarray(bias), c_tile=32,
                           use_kernel=repro_kernel, interpret=repro_kernel)
    got = tops.fused_topk(to_torch(q), got_c, torch.as_tensor(cid), k,
                          bias=None if bias is None else torch.as_tensor(bias))
    assert got[0].shape == (b, k) and got[1].dtype == torch.int32
    assert_topk_match(got, want)


@pytest.mark.parametrize("with_bias", [False, True])
def test_quant_vs_ids_edge_rows(with_bias):
    """By id over an int8 corpus: all-PAD rows, k above the live count,
    planted ties (lowest position first), a zero row and a row at +-127."""
    rng = np.random.default_rng(31)
    corpus = _extreme_rows(rng, rows=60, dd=32)
    want_c, got_c = both_quantized(corpus)
    q = random_fused(rng, (5,), d_dense=32, ps=6, pf=4)
    ids = rng.integers(0, 60, size=(5, 12)).astype(np.int32)
    ids[0] = PAD_IDX
    ids[1, 3:] = PAD_IDX
    ids[2] = 17
    ids[3, ::2] = 5
    ids[4, :4] = [0, 2, 3, 1]  # zero row, -127 row, +-127 row, denormal row
    bias = rng.normal(size=ids.shape).astype(np.float32) if with_bias else None
    if bias is not None:
        bias[2:4] = 0.0
    k = 9
    tq, tids = to_torch(q), torch.as_tensor(ids)
    want = rops.fused_topk_vs_ids(to_jax(q), want_c, jnp.asarray(ids), k,
                                  bias=None if bias is None else jnp.asarray(bias),
                                  use_kernel=False)
    got = tops.fused_topk_vs_ids(tq, got_c, tids, k,
                                 bias=None if bias is None else torch.as_tensor(bias))
    assert_topk_match(got, want)
    s, p = got[0].numpy(), got[1].numpy()
    assert np.all(s[0] == tref.NEG) and np.all(p[0] == PAD_IDX)
    assert np.all(p[1, 3:] == PAD_IDX) and np.all(p[1, :3] >= 0)
    np.testing.assert_array_equal(p[2], np.arange(k))
    tied = p[3][p[3] % 2 == 0]
    np.testing.assert_array_equal(tied, np.sort(tied))
    ws = np.asarray(rops.hybrid_scores_vs_ids(to_jax(q), want_c, jnp.asarray(ids),
                                              use_kernel=False))
    gs = tops.hybrid_scores_vs_ids(tq, got_c, tids).numpy()
    np.testing.assert_array_equal(np.isneginf(gs), ids < 0)
    live = ids >= 0
    np.testing.assert_allclose(gs[live], ws[live], rtol=TOL, atol=TOL)


def test_corpus_dtype_validated():
    assert resolve_params(SearchParams(corpus_dtype="int8")).corpus_dtype == "int8"
    with pytest.raises(ValueError, match="corpus_dtype"):
        resolve_params(SearchParams(corpus_dtype="int4"))


def test_kernel_checks_reject_bad_int8_operands():
    """The CUDA wrappers' operand checks: int8 dense, f32 scale, f16 values,
    int32 ids, contiguous; anything else raises before a launch."""
    rng = np.random.default_rng(5)
    q = to_torch(random_fused(rng, (2,), d_dense=16, ps=4, pf=3))
    c = tusms.quantize_corpus(to_torch(random_fused(rng, (20,), d_dense=16, ps=4, pf=3)))
    ids = torch.zeros((2, 5), dtype=torch.int32)
    check_query_corpus(q, c, ids)
    bad = [
        dataclasses.replace(c, dense_q=c.dense_q.to(torch.int16)),
        dataclasses.replace(c, dense_scale=c.dense_scale.double()),
        dataclasses.replace(c, learned=tusms.SparseVec(c.learned.idx, c.learned.val.float())),
        dataclasses.replace(c, lexical=tusms.SparseVec(c.lexical.idx.long(), c.lexical.val)),
        dataclasses.replace(c, dense_q=c.dense_q.t().contiguous().t()),
    ]
    for b in bad:
        with pytest.raises(ValueError):
            check_query_corpus(q, b, ids)
    with pytest.raises(ValueError):
        check_query_corpus(q, c, ids.long())


# ---------------------------------------------------------------------------
# search on a repro-built index in int8 storage
# ---------------------------------------------------------------------------

PARAMS = dict(k=10, iters=32, pool_size=48, corpus_dtype="int8")


@pytest.fixture(scope="module")
def built():
    corpus = make_corpus(CorpusConfig(n_docs=384, n_queries=12, n_topics=12, d_dense=32,
                                      nnz_sparse=12, nnz_lexical=8, seed=7))
    cfg = RBuildConfig(knn=RKnnConfig(k=16, iters=3, node_chunk=512, use_kernel=False),
                       prune=RPruneConfig(degree=12, keyword_degree=6, node_chunk=256,
                                          use_kernel=False), path_refine_iters=1)
    r_index = r_build_index(jax.tree.map(jnp.asarray, corpus.docs), cfg)
    r_index = dataclasses.replace(r_index, corpus=rusms.quantize_corpus(r_index.corpus))
    return corpus, r_index, index_from_arrays(r_index, "cpu")


@pytest.mark.parametrize("use_keywords", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_int8_search_on_repro_index_matches_repro(built, mode, use_keywords):
    corpus, r_idx, t_idx = built
    assert isinstance(t_idx.corpus, tusms.QuantizedFusedVectors)
    assert t_idx.corpus.learned.val.dtype == torch.float16
    w = (1.0, 0.7, 0.4)
    extra = dict(keywords=corpus.query_keywords) if use_keywords else {}
    want = r_search(r_idx, jax.tree.map(jnp.asarray, corpus.queries),
                    RFusionSpec.make(mode, *w),
                    RSearchParams(use_kernel=False, use_keywords=use_keywords, **PARAMS),
                    **{k: jnp.asarray(v) for k, v in extra.items()})
    got = search(t_idx, to_torch(corpus.queries), FusionSpec.make(mode, *w),
                 SearchParams(use_keywords=use_keywords, **PARAMS), device="cpu", **extra)
    gi, wi = got.ids.numpy(), np.asarray(want.ids)
    gs, ws = got.scores.numpy(), np.asarray(want.scores)
    np.testing.assert_allclose(gs, ws, rtol=TOL, atol=TOL)
    flip = gi != wi
    assert np.all(np.abs(gs - ws)[flip] <= TOL), f"ids diverged beyond ties:\n{gi}\n{wi}"
    np.testing.assert_allclose(got.path_scores.numpy(), np.asarray(want.path_scores),
                               rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got.expanded.numpy(), np.asarray(want.expanded))


def test_int8_corpus_converts_without_widening(built):
    _, r_idx, t_idx = built
    c = corpus_from_arrays(r_idx.corpus, "cpu")
    assert c.dense_q.dtype == torch.int8 and c.lexical.val.dtype == torch.float16
    np.testing.assert_array_equal(c.dense_q.numpy(), np.asarray(r_idx.corpus.dense_q))
    assert t_idx.nbytes() < index_from_arrays(
        dataclasses.replace(r_idx, corpus=rusms.dequantize_corpus(r_idx.corpus)), "cpu").nbytes()
