"""CPU rehearsal of the pair-tile and hybrid-distance kernels' algorithms
(csrc/pairwise_tile.cu, csrc/hybrid_distance.cu, csrc/common.cuh).

The CUDA kernels have no CPU mode, so their new parts are modelled here in
plain PyTorch, step for step, and held against the plain versions
(``pairwise_tile_plain``, ``hybrid_distance_plain`` / ``_int8_plain``):

* the 3xTF32 split of the Gram (hi rounded to TF32 by integer operations,
  lo = x - hi read by the MMA truncated to TF32, three products summed in
  fp32, a fresh partial per ring stage) and its error bound;
* which warp owns which 16 x 8 output block of the Gram: every (i, j)
  exactly once;
* the sorted ELL rows (kNoPos-padded to a power of two), the fixed-step
  binary search and the thread per pair i <= j summing row i's entries in
  order, mirrored to (j, i);
* the warp form of the distance kernel: which warp scores which (query row,
  candidate), the query words a lane holds, the query ELL sorted across the
  lanes and the binary search over them.

Imports no jax.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.usms import FusedVectors, SparseVec, quantize_corpus  # noqa: E402
from repro_torch.kernels import hybrid_distance as hd  # noqa: E402
from repro_torch.kernels.pairwise_tile import pairwise_tile_plain  # noqa: E402

CSRC = Path(hd.__file__).parent / "csrc"
TOL = 1e-4  # chip_smoke.py's limit for every kernel against its plain version
WARP = 32
NO_POS = 2**31 - 1
BK = 64  # csrc/pairwise_tile.cu kBK: floats of a row a ring stage holds


def _consts(name: str) -> dict:
    src = (CSRC / name).read_text()
    return {m[1]: m[2] for m in re.finditer(r"constexpr int (k\w+) = ([^;]+);", src)}


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------


def _ell(rng, rows, cap, vocab, pad_rows=()):
    idx = np.full((rows, cap), -1, np.int32)
    val = np.zeros((rows, cap), np.float32)
    for r in range(rows):
        if r in pad_rows:
            continue
        k = rng.integers(1, cap + 1)
        idx[r, :k] = rng.choice(vocab, size=k, replace=False)
        val[r, :k] = rng.uniform(0.1, 1.5, size=k)
    return SparseVec(torch.as_tensor(idx), torch.as_tensor(val))


def _fused(rng, rows, dd=64, ps=32, pf=16, pad_rows=(), unit=True):
    dense = rng.normal(size=(rows, dd)).astype(np.float32)
    if unit:  # the corpus's rows are unit vectors (BGE-M3-like)
        dense /= np.linalg.norm(dense, axis=1, keepdims=True)
    # small vocabularies: rows share ids, so the intersections are not empty
    return FusedVectors(torch.as_tensor(dense), _ell(rng, rows, ps, 61, pad_rows),
                        _ell(rng, rows, pf, 29, pad_rows))


# ---------------------------------------------------------------------------
# the model of pairwise_tile_kernel
# ---------------------------------------------------------------------------


def split_tf32(x: torch.Tensor):
    """csrc/mma.cuh split_tf32: hi = bits + 0x1000, low 13 bits cleared; lo
    = x - hi in fp32; the MMA reads lo truncated to TF32."""
    bits = x.view(torch.int32)
    hi = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    lo = x - hi
    lo_read = (lo.view(torch.int32) & ~0x1FFF).view(torch.float32)
    return hi, lo_read


def gram_3xtf32(x: torch.Tensor, stage: int = BK) -> torch.Tensor:
    """X X^T of one node's (K, Dd) rows as the kernel sums it: per stage of
    ``stage`` columns a fresh fp32 partial of lo hi + hi lo + hi hi, added
    to the total once. (The tensor cores' own rounding inside an MMA is not
    modelled: each product of two TF32 values is exact in fp32.)"""
    hi, lo = split_tf32(x)
    acc = torch.zeros((x.shape[0], x.shape[0]), dtype=torch.float32)
    for d0 in range(0, max(x.shape[1], 1), stage):
        h, l_ = hi[:, d0:d0 + stage], lo[:, d0:d0 + stage]
        acc = acc + ((l_ @ h.T + h @ l_.T) + h @ h.T)
    return acc


def warp_tiles(kp: int, warp: int, warps: int = 4):
    """csrc/pairwise_tile.cu warp_tiles: (16-row block, [8-column blocks])."""
    rows, cols = kp // 16, kp // 8
    groups = rows if rows <= 2 else warps
    mt, nstep, nt0 = warp % groups, warps // groups, warp // groups
    n = (cols - nt0 + nstep - 1) // nstep if mt < rows and nt0 < cols else 0
    return mt, [nt0 + u * nstep for u in range(n)]


def pow2_at_least(x: int) -> int:
    p = 1
    while p < x:
        p <<= 1
    return p


def sort_row(idx: np.ndarray, val: np.ndarray, pp: int):
    """A row's live ids ascending, padded with NO_POS (value 0) to pp slots."""
    live = idx >= 0
    order = np.argsort(idx[live], kind="stable")
    sid = np.full(pp, NO_POS, np.int64)
    sval = np.zeros(pp, np.float32)
    sid[: live.sum()] = idx[live][order]
    sval[: live.sum()] = val[live][order]
    return sid, sval


def lower_pos(row: np.ndarray, pp: int, key: int) -> int:
    """csrc/pairwise_tile.cu lower_pos: fixed steps over pp (a power of two)."""
    pos, step = 0, pp >> 1
    while step >= WARP:
        if row[pos + step - 1] < key:
            pos += step
        step >>= 1
    step = WARP // 2
    while step > 0:
        if step < pp and row[pos + step - 1] < key:
            pos += step
        step >>= 1
    return pos


def pair_path(ri, vi, rj, vj, pp: int) -> np.float32:
    """Row i's live entries in order, each looked up in row j, summed in fp32."""
    s = np.float32(0.0)
    for t in range(pp):
        if ri[t] == NO_POS:
            break
        pos = lower_pos(rj, pp, ri[t])
        if rj[pos] == ri[t]:
            s = np.float32(s + np.float32(vi[t] * vj[pos]))
    return s


def model_tile(corpus: FusedVectors, ids: np.ndarray) -> torch.Tensor:
    """The kernel's (C, K, K) output, step for step: the Gram in 3xTF32, the
    sparse pairs i <= j mirrored, (dense + learned) + lexical."""
    c, k = ids.shape
    out = torch.empty((c, k, k), dtype=torch.float32)
    paths = []
    for sv in (corpus.learned, corpus.lexical):
        pp = pow2_at_least(sv.idx.shape[1])
        rows = [sort_row(sv.idx[r].numpy(), sv.val[r].numpy(), pp) for r in range(corpus.n)]
        paths.append((rows, pp))
    for node in range(c):
        g = gram_3xtf32(corpus.dense[ids[node].astype(np.int64)]).numpy()
        for i in range(k):
            for j in range(i, k):
                s, f = (pair_path(*rows[ids[node, i]], *rows[ids[node, j]], pp)
                        for rows, pp in paths)
                g[i, j] = np.float32(np.float32(g[i, j] + s) + f)
                if j > i:
                    g[j, i] = np.float32(np.float32(g[j, i] + s) + f)
        out[node] = torch.as_tensor(g)
    return out


# ---------------------------------------------------------------------------
# the model of hybrid_distance_warp_kernel
# ---------------------------------------------------------------------------


def warp_split(b: int, c: int, sms: int = 132) -> int:
    """csrc/hybrid_distance.cu warp_split: warps sharing a query row."""
    want = sms * int(_consts("hybrid_distance.cu")["kWarpsPerSm"])
    return max(1, min(c, -(-want // b)))


def warp_form_cover(b: int, c: int) -> np.ndarray:
    """How many times the warp form scores each (query row, candidate)."""
    split = warp_split(b, c)
    seen = np.zeros((b, c), np.int64)
    for w in range(b * split):
        row, part = divmod(w, split)
        seen[row, part::split] += 1
    return seen


def query_words(dd: int, quant: bool) -> np.ndarray:
    """(lane, register word) -> the query's 16-byte word index, as
    rt::WarpQuery<View>::word lays them out (-1: past the row)."""
    words = int(_consts("common.cuh")["kQueryWords"])
    out = np.full((WARP, words), -1)
    for lane in range(WARP):
        for u in range(words):
            i = 4 * ((u >> 2) * WARP + lane) + (u & 3) if quant else u * WARP + lane
            out[lane, u] = i if i < dd // 4 else -1
    return out


def lane_match(key: int, val: float, qid: np.ndarray, qval: np.ndarray, n: int) -> float:
    """rt::lane_match: a binary search over the query's sorted ids (one a
    lane), six halving steps."""
    lo, hi = 0, n
    for _ in range(6):
        mid = (lo + hi) >> 1
        x = qid[mid & (WARP - 1)]
        if lo < hi:
            if x < key:
                lo = mid + 1
            else:
                hi = mid
    x, xv = qid[lo & (WARP - 1)], qval[lo & (WARP - 1)]
    return float(np.float32(val * xv)) if key >= 0 and lo < n and x == key else 0.0


def model_distance(q: FusedVectors, corpus, ids: np.ndarray) -> np.ndarray:
    """The warp form's scores: each query's ELL rows sorted across the lanes
    (dead lanes NO_POS), each corpus slot matched by lane_match; the dense
    dot scaled once for int8 storage; PAD and out-of-range ids -inf."""
    quant = hasattr(corpus, "dense_q")
    dense = corpus.dense_q.float() if quant else corpus.dense
    out = np.full(ids.shape, -np.inf, np.float32)
    for b in range(ids.shape[0]):
        qs = [sort_row(sv.idx[b].numpy(), sv.val[b].numpy(), WARP) for sv in (q.learned, q.lexical)]
        ns = [int((sv.idx[b] >= 0).sum()) for sv in (q.learned, q.lexical)]
        for c, row in enumerate(ids[b]):
            if row < 0 or row >= corpus.n:
                continue
            d = float(q.dense[b] @ dense[row])
            if quant:
                d *= float(corpus.dense_scale[row])
            sparse = []
            for (qid, qval), n, sv in zip(qs, ns, (corpus.learned, corpus.lexical)):
                sparse.append(sum(lane_match(int(k), float(v), qid, qval, n)
                                  for k, v in zip(sv.idx[row], sv.val[row].float())))
            out[b, c] = (d + sparse[0]) + sparse[1]
    return out


# ---------------------------------------------------------------------------
# tests: pairwise_tile
# ---------------------------------------------------------------------------


def test_split_keeps_fp32_grade_products():
    """3xTF32 loses ~2^-20 of each product; one TF32 product (hi hi) loses
    ~2^-11, too much for TOL at Dd 1024 on unnormalised rows."""
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(32, 1024)).astype(np.float32))
    exact = x.double() @ x.double().T
    bound = (x.double().abs() @ x.double().abs().T) * 2.0**-19
    got = gram_3xtf32(x).double()
    assert bool(((got - exact).abs() <= bound + 1e-5 * exact.abs()).all())
    hi, _ = split_tf32(x)
    one = (hi.double() @ hi.double().T - exact).abs().max().item()
    assert one > 100 * (got - exact).abs().max().item()
    assert one > TOL
    # hi carries x to TF32's 10 bits, rounded: |x - hi| <= 2^-11 |x|
    assert bool(((x - hi).abs() <= 2.0**-11 * x.abs()).all())


@pytest.mark.parametrize("k", [1, 12, 32, 64])
def test_warps_own_every_output_entry_once(k):
    kp = (k + 15) // 16 * 16
    seen = np.zeros((kp, kp), np.int64)
    for warp in range(4):
        mt, nts = warp_tiles(kp, warp)
        assert len(nts) <= (2 if k <= 32 else 8)  # the kernel's T
        for nt in nts:
            seen[mt * 16:(mt + 1) * 16, nt * 8:(nt + 1) * 8] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("k", [1, 12, 32, 64])
def test_model_matches_plain(k):
    """The kernel's arithmetic against the plain version, with an all-PAD
    row on both paths and planted identical rows (identical outputs, bit for
    bit, as the kernel's fixed order gives them)."""
    rng = np.random.default_rng(k)
    corpus = _fused(rng, 90, dd=96, pad_rows=(3,))
    ids = rng.integers(0, 90, size=(3, k)).astype(np.int32)
    ids[:, 0] = 3
    if k > 6:
        ids[0, 6] = ids[0, 5]
    got = model_tile(corpus, ids)
    want = pairwise_tile_plain(corpus, torch.as_tensor(ids))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=TOL)
    if k > 6:
        assert torch.equal(got[0, 5], got[0, 6])
        assert torch.equal(got[0, :, 5], got[0, :, 6])


def test_binary_search_finds_every_live_id():
    rng = np.random.default_rng(3)
    for p in (1, 5, 16, 32, 33, 64):
        pp = pow2_at_least(p)
        idx = np.full(p, -1, np.int32)
        n = rng.integers(0, p + 1)
        idx[:n] = rng.choice(1000, size=n, replace=False)
        sid, _ = sort_row(idx, np.ones(p, np.float32), pp)
        for t in range(n):
            pos = lower_pos(sid, pp, int(sid[t]))
            assert sid[pos] == sid[t]
        for key in (-1, 1000, 1001):
            assert sid[lower_pos(sid, pp, key)] != key


def test_kernel_constants_are_the_models():
    const = _consts("pairwise_tile.cu")
    assert const["kBK"] == str(BK) and const["kWarps"] == "4" and const["kMaxK"] == "64"
    assert const["kLd"] == "kBK + 4"  # 272-byte rows: ldmatrix without bank conflicts
    assert "(x + 0x1000u) & 0xffffe000u" in (CSRC / "mma.cuh").read_text()


# ---------------------------------------------------------------------------
# tests: hybrid_distance
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,c", [(2**20, 1), (65536, 1), (1024, 16), (3072, 80), (32, 16),
                                 (96, 80), (40, 16), (9, 80)])
def test_warp_form_scores_each_candidate_once(b, c):
    if b * c > 2**17:  # the large shapes: split 1, one warp a row
        assert warp_split(b, c) == 1
        return
    assert (warp_form_cover(b, c) == 1).all()


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("dd", [64, 1024])
def test_query_words_cover_the_row_in_the_scorers_order(dd, quant):
    """Each 16-byte query word is held by exactly one (lane, register), and
    the lane holds the words its corpus loads multiply, as dense_partial
    reads them from shared memory."""
    lanes = 16 if quant else 4
    if dd % lanes:
        pytest.skip("the warp form takes 16-byte rows only")
    w = query_words(dd, quant)
    held = np.sort(w[w >= 0])
    np.testing.assert_array_equal(held, np.arange(dd // 4))
    for lane in range(WARP):
        if quant:  # corpus word i = v * 32 + lane multiplies query words 4 i .. 4 i + 3
            for v in range(2):
                i = v * WARP + lane
                if i < dd // 16:
                    np.testing.assert_array_equal(w[lane, 4 * v:4 * v + 4], 4 * i + np.arange(4))
        else:
            for u in range(w.shape[1]):
                i = u * WARP + lane
                assert w[lane, u] == (i if i < dd // 4 else -1)


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("c", [1, 16, 80])
def test_warp_form_model_matches_plain(c, quant):
    """The warp form's scoring against the plain version: an all-PAD row, an
    out-of-range id, a row of repeats; all-PAD query ELL rows."""
    rng = np.random.default_rng(c + quant)
    b, n = 6, 120
    q = _fused(rng, b, ps=12, pf=6, pad_rows=(1,), unit=False)
    corpus = _fused(rng, n, pad_rows=(5,), unit=False)
    ids = rng.integers(0, n, size=(b, c)).astype(np.int32)
    ids[rng.random(ids.shape) < 0.2] = -1
    ids[0] = -1
    ids[2, 0] = n + 3
    ids[3] = 5
    if quant:
        corpus = quantize_corpus(corpus)
    got = model_distance(q, corpus, ids)
    tid = torch.as_tensor(ids)
    plain = hd.hybrid_distance_int8_plain if quant else hd.hybrid_distance_plain
    want = plain(q, corpus, tid.clamp(max=n - 1)).numpy()
    valid = (ids >= 0) & (ids < n)
    assert np.isneginf(got[~valid]).all()
    np.testing.assert_allclose(got[valid], want[valid], rtol=1e-5, atol=TOL)


def test_shape_constant_splits_the_main_path_shapes():
    """The warp form takes every main-path launch (self scores and per-path
    norms at C 1, entry scoring at C 16, the final re-score at C 80, the
    served B 32 C 16 and B 96 C 80); the block form phase 2's large shape."""
    for c in (1, 16, 80):
        assert c <= hd.SMALL_C_MAX
    assert 1032 > hd.SMALL_C_MAX
    rng = np.random.default_rng(1)
    for dd, ok in ((1024, True), (64, True), (1028, False), (42, False)):
        q, corpus = _fused(rng, 2, dd=dd, unit=False), _fused(rng, 4, dd=dd, unit=False)
        assert hd.warp_form(q, corpus, 16) == ok
        assert not hd.warp_form(q, corpus, 1032)
        if ok and dd % 16 == 0:
            assert hd.warp_form(q, quantize_corpus(corpus), 80)
    wide = _fused(rng, 2, ps=40, unit=False)
    assert not hd.warp_form(wide, _fused(rng, 4, unit=False), 16)  # query ELL wider than a warp


def test_distance_constants_are_the_models():
    common, dist = _consts("common.cuh"), _consts("hybrid_distance.cu")
    assert int(common["kQueryWords"]) * WARP * 4 == hd.WARP_FORM_MAX_DD
    assert hd.WARP_FORM_MAX_SLOTS == WARP
    assert common["kOnePassVec"] == "4" and dist["kWarpFormWarps"] == "8"
