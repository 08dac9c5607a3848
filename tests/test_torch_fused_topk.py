"""CPU rehearsal of the fused top-k kernel's algorithm (csrc/fused_topk.cu).

The CUDA kernel has no CPU mode, so its two new parts are modelled here in
plain PyTorch, step for step, and held exactly against the plain version
(``fused_topk_plain`` / ``fused_topk_int8_plain``) and ``ops.fused_topk_vs_ids``:

* the ordered form's counting pass (histogram of each row's live ids by id
  range, scan, scatter) and the scoring walk over it, range by range;
* the selection: each warp's running top-k of 32 M keys kept sorted by the
  kernel's bitonic network (the same compare-exchange steps, lane ^ d for
  the shuffles), a batch skipped when none of its keys beats the list's
  k-th, and the block's one merge of its warps' lists; k > 64 takes k rounds
  of an arg-max.

The key (score desc, position asc) is a strict total order, so a correct
selection over the plain version's own scores gives its output exactly:
the model is fed those scores, and nothing is compared up to a tolerance.
Imports no jax.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.usms import FusedVectors, SparseVec, quantize_corpus  # noqa: E402
from repro_torch.kernels import fused_topk as ft  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

WARP = 32
NO_POS = 2**31 - 1
NEG = ref.NEG


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def beats(v, p, w, q):
    return (v > w) | ((v == w) & (p < q))


def cx(v, p, d: int, direction: int):
    """One compare-exchange step at distance d over the last axis (element
    e = 32 j + lane): e and e ^ d, the lower keeping the better key where
    (e & direction) == 0."""
    e = torch.arange(v.shape[-1])
    partner = e ^ d
    ov, op = v[..., partner], p[..., partner]
    want_better = ((e & d) == 0) == ((e & direction) == 0)
    take = want_better == beats(ov, op, v, p)
    return torch.where(take, ov, v), torch.where(take, op, p)


def sort_keys(v, p):
    size = 2
    while size <= v.shape[-1]:
        d = size // 2
        while d > 0:
            v, p = cx(v, p, d, size)
            d //= 2
        size *= 2
    return v, p


def merge_keys(lv, lp, xv, xp):
    """The top 32 M of two sorted lists: the better of L[i] and X[32M-1-i],
    then the half-cleaner cascade."""
    xv, xp = xv.flip(-1), xp.flip(-1)
    take = beats(xv, xp, lv, lp)
    lv, lp = torch.where(take, xv, lv), torch.where(take, xp, lp)
    n = lv.shape[-1]
    d = n // 2
    while d > 0:
        lv, lp = cx(lv, lp, d, 2 * n)
        d //= 2
    return lv, lp


def warp_topk(rows, first: int, step: int, k: int, m: int):
    """One warp's running top-k over the batches first, first + step, ... of
    32 m positions of each row of ``rows`` (B, C); per row, as one block
    per row runs it."""
    b, c = rows.shape
    n = WARP * m
    lv = torch.full((b, n), float("-inf"))
    lp = torch.full((b, n), NO_POS, dtype=torch.int64)
    base = first * n
    while base < c:
        pos = torch.arange(base, base + n)
        xv = torch.where(pos < c, rows[:, pos.clamp(max=c - 1)], float("-inf"))
        xp = torch.where(pos < c, pos, NO_POS).expand(b, n)
        kv, kp = lv[:, k - 1:k], lp[:, k - 1:k]
        enter = beats(xv, xp, kv, kp).any(-1, keepdim=True)  # the warp's vote
        sv, sp = sort_keys(xv, xp)
        mv, mp = merge_keys(lv, lp, sv, sp)
        lv, lp = torch.where(enter, mv, lv), torch.where(enter, mp, lp)
        base += step * n
    return lv, lp


def block_topk(rows, k: int, warps: int):
    """The block's selection of each row's top k: the warps' running lists
    merged once by warp 0 (k <= 64), or k arg-max rounds (k > 64)."""
    b, c = rows.shape
    if k > 2 * WARP:
        work, vs, ps = rows.clone(), [], []
        for _ in range(k):
            key = torch.where(work > NEG, work, float("-inf"))
            bv, bp = key.max(-1)  # max returns the first (lowest) position of ties
            live = bv > NEG
            vs.append(torch.where(live, bv, NEG))
            ps.append(torch.where(live, bp, -1))
            work[torch.arange(b)[live], bp[live]] = float("-inf")
        return torch.stack(vs, 1), torch.stack(ps, 1).to(torch.int32)
    m = 1 if k <= WARP else 2
    batches = -(-c // (WARP * m))
    lv, lp = warp_topk(rows, 0, warps, k, m)
    for w in range(1, min(warps, batches)):
        lv, lp = merge_keys(lv, lp, *warp_topk(rows, w, warps, k, m))
    live = lv[:, :k] > NEG
    return (torch.where(live, lv[:, :k], NEG),
            torch.where(live, lp[:, :k], -1).to(torch.int32))


SCAN_TILE = 4096  # counters per block of the kernel's scan


def sort_pairs(ids, n: int):
    """The counting sort: a histogram of the live ids, the three-phase
    exclusive scan (tile sums, a scan of them, the prefix within each tile)
    and the scatter of (id, b * C + c) by id. Returns (sorted pairs (P, 2),
    start (n + 1,))."""
    flat = ids.reshape(-1).long()
    live = (flat >= 0) & (flat < n)
    count = torch.zeros(n, dtype=torch.int64).index_add_(
        0, flat[live], torch.ones(int(live.sum()), dtype=torch.int64))
    tiles = -(-n // SCAN_TILE)
    tile_sum = torch.stack([count[t * SCAN_TILE:(t + 1) * SCAN_TILE].sum() for t in range(tiles)])
    tile_pre = torch.cumsum(tile_sum, 0) - tile_sum
    start = torch.zeros(n + 1, dtype=torch.int64)
    for t in range(tiles):
        blk = count[t * SCAN_TILE:(t + 1) * SCAN_TILE]
        start[t * SCAN_TILE:t * SCAN_TILE + blk.numel()] = tile_pre[t] + torch.cumsum(blk, 0) - blk
    start[n] = int(tile_sum.sum())
    out = torch.full((int(start[n]), 2), -1, dtype=torch.int64)
    fill = torch.zeros(n, dtype=torch.int64)
    for i in live.nonzero().flatten().tolist():  # any order within an id will do
        rid = int(flat[i])
        out[start[rid] + fill[rid]] = torch.tensor([rid, i])
        fill[rid] += 1
    return out, start


def score_ordered(scores, ids, n: int, per_warp: int = 16):
    """The ordered form up to its scratch: dead positions NEG from the
    histogram pass; live ones written by the scoring walk, warp w taking
    sorted pairs [w P, (w + 1) P) and loading a row where the id changes,
    each pair's score taken from ``scores`` (the plain version's). Returns
    (scratch, rows loaded)."""
    b, c = ids.shape
    pairs, start = sort_pairs(ids, n)
    scratch = torch.full((b * c,), float("nan"))
    scratch[((ids < 0) | (ids >= n)).reshape(-1)] = NEG
    loads = 0
    for w in range(-(-int(start[n]) // per_warp)):
        cur = -1
        for rid, i in pairs[w * per_warp:(w + 1) * per_warp].tolist():
            if rid != cur:
                loads, cur = loads + 1, rid
            assert torch.isnan(scratch[i]), "a position scored twice"
            scratch[i] = scores.reshape(-1)[i]
    assert not torch.isnan(scratch).any(), "a position never scored"
    return scratch.reshape(b, c), loads


def one_pass_warps(b: int, c: int) -> int:
    """Warps of a one-pass block: a warp per candidate, up to 32 at B <= 264
    and 4 above."""
    return max(1, min(c, 32 if b <= 264 else 4))


def model(q, corpus, ids, k: int, bias, ordered: bool):
    """The kernel's algorithm on the plain version's scores."""
    quant = hasattr(corpus, "dense_q")
    s = (ref.hybrid_scores_quant_ref if quant else ref.hybrid_scores_ref)(q, corpus.take(ids))
    if bias is not None:
        s = s + bias
    if ordered:
        return block_topk(score_ordered(s, ids, corpus.n)[0], k, 4)
    s = torch.where((ids >= 0) & (ids < corpus.n), s, torch.full_like(s, NEG))
    return block_topk(s, k, one_pass_warps(*ids.shape))


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------


def _ell(rng, rows, cap, vocab):
    idx = np.full((rows, cap), -1, np.int32)
    val = np.zeros((rows, cap), np.float32)
    for r in range(rows):
        k = rng.integers(0, cap + 1)
        idx[r, :k] = rng.choice(vocab, size=k, replace=False)
        val[r, :k] = rng.uniform(0.1, 1.5, size=k)
    return SparseVec(torch.as_tensor(idx), torch.as_tensor(val))


def _fused(rng, rows, dd=16, ps=6, pf=4):
    dense = torch.as_tensor(rng.normal(size=(rows, dd)).astype(np.float32))
    return FusedVectors(dense, _ell(rng, rows, ps, 41), _ell(rng, rows, pf, 23))


def _case(seed, b, c, n=200, pad=0.2, bias=True, quant=False, outside=False):
    """Queries, corpus, ids with edge rows (0: all PAD, 1: three live, 2: one
    repeated id, 3: a repeated id at even positions; with ``outside``, 4:
    ids past n, which the kernel skips as PAD but the plain version clamps),
    bias (zero on the tie rows)."""
    rng = np.random.default_rng(seed)
    q, corpus = _fused(rng, b, ps=5, pf=3), _fused(rng, n)
    ids = rng.integers(0, n, size=(b, c)).astype(np.int32)
    ids[rng.random(ids.shape) < pad] = -1
    ids[0] = -1
    ids[1] = -1
    ids[1, :3] = [11, 22, 33]
    ids[2] = 17
    ids[3, ::2] = 29
    if outside:
        ids[4, : c // 2] = n + 5
    bvals = rng.normal(size=ids.shape).astype(np.float32)
    bvals[2:4] = 0.0
    if quant:
        corpus = quantize_corpus(corpus)
    return (q, corpus, torch.as_tensor(ids),
            torch.as_tensor(bvals) if bias else None)


def _plain(q, corpus, ids, k, bias):
    fn = ft.fused_topk_int8_plain if hasattr(corpus, "dense_q") else ft.fused_topk_plain
    return fn(q, corpus, ids, k, bias)


def _assert_exact(got, want):
    np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [200, 5000, 9000])  # one scan tile, two, three
def test_counting_sort_is_a_permutation_of_the_live_pairs(n):
    _, _, ids, _ = _case(n, 9, 40, n=n, outside=True)
    pairs, start = sort_pairs(ids, n)
    flat = ids.reshape(-1).tolist()
    live = [(i, p) for p, i in enumerate(flat) if 0 <= i < n]
    got = [tuple(x) for x in pairs.tolist()]
    assert sorted(got) == sorted(live)
    assert [i for i, _ in got] == sorted(i for i, _ in live), "pairs not grouped by id"
    assert int(start[n]) == len(live)
    for rid in {i for i, _ in live}:
        lo, hi = int(start[rid]), int(start[rid + 1])
        assert all(i == rid for i, _ in got[lo:hi]) and hi - lo == flat.count(rid)


def test_scoring_walk_loads_each_row_about_once():
    """Repeated ids load their row once per warp window: at most the unique
    ids plus one per warp."""
    _, corpus, ids, _ = _case(2, 16, 64, n=50, pad=0.3)
    live = ids[(ids >= 0) & (ids < 50)]
    scores = torch.zeros(ids.shape)
    _, loads = score_ordered(scores, ids, 50)
    uniq, warps = int(torch.unique(live).numel()), -(-live.numel() // 16)
    assert uniq <= loads <= uniq + warps
    assert loads < live.numel() / 2


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("ordered", [False, True], ids=["one_pass", "ordered"])
@pytest.mark.parametrize("k", [12, 16, 24, 32, 64])
def test_model_matches_plain(k, ordered, quant):
    q, corpus, ids, bias = _case(k, 12, 72, quant=quant)
    want = _plain(q, corpus, ids, k, bias)
    got = model(q, corpus, ids, k, bias, ordered)
    _assert_exact(got, want)
    _assert_exact(ops.fused_topk_vs_ids(q, corpus, ids, k, bias=bias), want)
    assert bool((got[1][0] == -1).all()) and bool((got[0][0] == NEG).all()), "all-PAD row"
    assert bool((got[1][1, 3:] == -1).all()) and bool((got[1][1, :3] >= 0).all()), "k > live"
    assert torch.equal(got[1][2], torch.arange(k, dtype=torch.int32)), "ties: lowest first"
    tied = got[1][3][got[1][3] % 2 == 0]
    assert torch.equal(tied, torch.sort(tied).values), "ties: order"


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("ordered", [False, True], ids=["one_pass", "ordered"])
@pytest.mark.parametrize("c", [24, 40, 64])
def test_model_k_equals_c(c, ordered, quant):
    q, corpus, ids, bias = _case(c, 10, c, quant=quant)
    _assert_exact(model(q, corpus, ids, c, bias, ordered), _plain(q, corpus, ids, c, bias))


@pytest.mark.parametrize("ordered", [False, True], ids=["one_pass", "ordered"])
@pytest.mark.parametrize("c,k", [(8, 24), (30, 64), (100, 80)])
def test_model_k_beyond_live_and_general_path(c, k, ordered):
    """k > C (sentinel slots), and k > 64 (the arg-max rounds)."""
    q, corpus, ids, bias = _case(c + k, 8, c, pad=0.5)
    _assert_exact(model(q, corpus, ids, k, bias, ordered), _plain(q, corpus, ids, k, bias))


@pytest.mark.parametrize("m", [1, 2])
def test_bitonic_network_sorts_and_merges(m):
    """The network alone, on random keys with repeats: sort gives (value
    desc, position asc); merge gives the top 32 m of both lists."""
    rng = np.random.default_rng(m)
    n = WARP * m
    v = torch.as_tensor(rng.integers(0, 9, size=(50, n)).astype(np.float32))
    p = torch.as_tensor(np.stack([rng.permutation(n) for _ in range(50)]))
    sv, sp = sort_keys(v, p)
    key = -v * 1000 + p  # values are small ints: a total order by (v desc, p asc)
    want = torch.sort(key, dim=1).indices
    np.testing.assert_array_equal(sp.numpy(), torch.gather(p, 1, want).numpy())
    xv, xp = sort_keys(v.flip(-1), p + n)
    mv, mp = merge_keys(sv, sp, xv, xp)
    allv, allp = torch.cat([v, v.flip(-1)], 1), torch.cat([p, p + n], 1)
    top = torch.sort(-allv * 10000 + allp, dim=1).indices[:, :n]
    np.testing.assert_array_equal(mp.numpy(), torch.gather(allp, 1, top).numpy())
    np.testing.assert_array_equal(mv.numpy(), torch.gather(allv, 1, top).numpy())


def test_model_constants_are_the_kernels():
    """The model's sizes and the wrapper's limit are the ones csrc/fused_topk.cu
    is built with."""
    import re
    from pathlib import Path

    src = (Path(ft.__file__).parent / "csrc" / "fused_topk.cu").read_text()
    const = {m[1]: m[2] for m in re.finditer(r"constexpr int (k\w+) = ([^;]+);", src)}
    assert const["kMaxSlots"] == str(ft.ORDERED_MAX_SLOTS)
    assert const["kPairsPerWarp"] == "16" and const["kSelectWarps"] == "4"
    assert const["kScanTile"] == "4 * kScanThreads" and const["kScanThreads"] == "1024"
    assert (const["kOnePassMaxWarps"], const["kOnePassWarps"], const["kSmallRows"]) == (
        "32", "4", "264")
    assert const["kMaxM"] == "2"


def test_wrapper_path_constant_splits_the_main_path_shapes():
    """Only the NN-Descent round chunk takes the ordered form."""
    assert 2048 * 1032 >= ft.ORDERED_MIN_PAIRS
    for b, c in ((2048, 152), (2048, 32), (2048, 12), (1024, 16), (32, 24), (64, 80)):
        assert b * c < ft.ORDERED_MIN_PAIRS
