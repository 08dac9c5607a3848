"""The plain reference: brute-force answers and the checks that decide
``correct``.

Plain PyTorch, on whatever device the caller's tensors lie on. It imports
nothing of the program: it works every number out again from the inputs the
benchmark made (the corpus rows of ``portbench.corpus``), and reads the
program's outputs only to judge them.

Storage. A ``Store`` is the corpus as a served index would hold it: fp32
rows (``store_fp32``), or per-row symmetric int8 dense rows with an fp32
scale and fp16 sparse values (``store_int8``, the seal-time format). The
controls use the next precision down: bf16 rows (``store_bf16``) and int4
dense rows (``store_int4``).

Scores. score(q, d) = <q.dense, d.dense> + <q.learned, d.learned> +
<q.lexical, d.lexical> per path; a fusion row fuses the three path scores:
weighted sum (w . s), zscore (sum_p w_p (s_p - mean_p) / std_p, with the
per-path stats taken from the L2 norms of the live stored rows) or RRF
(sum_p w_p / (k_rrf + 1 + rank_p)).

Exact answers. ``exact_topk`` ranks every eligible doc (alive and, for a
row with a required keyword, holding it) by the row's fused score, ties to
the lower id. RRF fuses each path's exact top ``RRF_DEPTH`` eligible docs, as
ranked lists are fused in practice.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from portbench.corpus import PAD, Rows

ZSCORE, RRF = "zscore", "rrf"
RRF_DEPTH = 1000  # each path's ranked list, as RRF fuses it
STD_FLOOR = 1e-6  # the floor of a zscore divisor
_DOC_CHUNK = 16384  # docs per brute-force step
_ROW_CHUNK = 2048  # answer rows per checking step


@dataclasses.dataclass
class Store:
    """A stored corpus: dense rows (``dense``, any float or int dtype) times
    ``scale`` (None for float rows), and the ELL sparse paths with their
    stored values."""

    dense: torch.Tensor
    scale: torch.Tensor | None
    learned_idx: torch.Tensor
    learned_val: torch.Tensor
    lexical_idx: torch.Tensor
    lexical_val: torch.Tensor

    @property
    def n(self) -> int:
        return self.dense.shape[0]

    def dense_rows(self, sel, dtype=torch.float64) -> torch.Tensor:
        rows = self.dense[sel].to(dtype)
        return rows if self.scale is None else rows * self.scale[sel].to(dtype)[..., None]


def store_fp32(d: Rows) -> Store:
    return Store(d.dense, None, d.learned_idx, d.learned_val, d.lexical_idx, d.lexical_val)


def store_bf16(d: Rows) -> Store:
    """The control of an fp32 corpus: every stored value rounded to bf16."""
    b = lambda t: t.to(torch.bfloat16)
    return Store(b(d.dense), None, d.learned_idx, b(d.learned_val), d.lexical_idx,
                 b(d.lexical_val))


def _symmetric(dense: torch.Tensor, levels: int):
    amax = dense.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / float(levels), torch.ones_like(amax)).float()
    q = torch.clamp(torch.round(dense / scale[:, None]), -levels, levels).to(torch.int8)
    return q, scale


def store_int8(d: Rows) -> Store:
    """The seal-time format: scale = max |row| / 127 (1 for an all-zero
    row), dense = round half to even of row / scale clipped to +-127, sparse
    values in fp16."""
    q, scale = _symmetric(d.dense, 127)
    h = lambda t: t.to(torch.float16)
    return Store(q, scale, d.learned_idx, h(d.learned_val), d.lexical_idx, h(d.lexical_val))


def store_int4(d: Rows) -> Store:
    """The control of an int8 corpus: dense rows on 15 levels (+-7)."""
    q, scale = _symmetric(d.dense, 7)
    h = lambda t: t.to(torch.float16)
    return Store(q, scale, d.learned_idx, h(d.learned_val), d.lexical_idx, h(d.lexical_val))


STORES = {"float32": store_fp32, "int8": store_int8, "bfloat16": store_bf16, "int4": store_int4}
CONTROL_OF = {"float32": "bfloat16", "int8": "int4"}


# ---------------------------------------------------------------------------
# fusion rows
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PathStats:
    """Per-path norm stats of the live stored rows, float64 (3,) each."""

    mean: torch.Tensor
    std: torch.Tensor


def path_stats(store: Store, alive: torch.Tensor) -> PathStats:
    """L2 norms of each path's live stored rows: their mean and std."""
    norms = [[], [], []]
    for s in range(0, store.n, _DOC_CHUNK):
        sel = slice(s, s + _DOC_CHUNK)
        live = alive[sel]
        norms[0].append(torch.linalg.vector_norm(store.dense_rows(sel), dim=-1)[live])
        norms[1].append(torch.linalg.vector_norm(store.learned_val[sel].double(), dim=-1)[live])
        norms[2].append(torch.linalg.vector_norm(store.lexical_val[sel].double(), dim=-1)[live])
    cat = [torch.cat(p) for p in norms]
    mean = torch.stack([c.mean() for c in cat])
    std = torch.stack([c.std(unbiased=False) for c in cat])
    return PathStats(mean.cpu(), std.cpu())


@dataclasses.dataclass
class FusionRows:
    """One fusion row per answer: its query, mode, path weights (R, 3),
    RRF constant and required keyword (PAD for none)."""

    query: np.ndarray  # (R,) int
    mode: list  # R mode names
    weights: np.ndarray  # (R, 3) float64
    rrf_k: np.ndarray  # (R,) float64
    keyword: np.ndarray  # (R,) int, PAD for none


def fusion_rows(specs: list, spec_of: np.ndarray, query: np.ndarray,
                keyword: np.ndarray | None = None) -> FusionRows:
    """Rows from the cell's spec table (dicts with ``mode``, ``weights``,
    optional ``rrf_k``) and each answer's spec index."""
    spec_of = np.asarray(spec_of)
    w = np.asarray([s["weights"] for s in specs], np.float64)[spec_of]
    rk = np.asarray([float(s.get("rrf_k", 60.0)) for s in specs], np.float64)[spec_of]
    kw = np.full(len(spec_of), PAD, np.int64) if keyword is None else np.asarray(keyword)
    return FusionRows(np.asarray(query), [specs[i]["mode"] for i in spec_of], w, rk, kw)


# ---------------------------------------------------------------------------
# path scores of given ids
# ---------------------------------------------------------------------------


def _sparse_pairs(q_idx, q_val, d_idx, d_val) -> torch.Tensor:
    """(R, Pq) queries x (R, k, Pd) rows -> (R, k) float64 inner products."""
    match = (d_idx[..., :, None] == q_idx[:, None, None, :]) & (d_idx[..., :, None] >= 0)
    qv = torch.where(match, q_val[:, None, None, :].double(), 0.0).sum(-1)
    return (qv * d_val.double()).sum(-1)


def path_scores(queries: Rows, store: Store, qi: torch.Tensor, ids: torch.Tensor):
    """Float64 per-path scores (R, k, 3) of rows ``ids`` (PAD -> 0) for
    queries ``qi``, and each pair's rounding scale ||q_p|| ||d_p|| (R, k, 3)."""
    safe = ids.clamp(min=0).long()
    q_dense = queries.dense[qi].double()
    d_dense = store.dense_rows(safe)
    dense = torch.einsum("rd,rkd->rk", q_dense, d_dense)
    ql_i, ql_v = queries.learned_idx[qi], queries.learned_val[qi]
    qf_i, qf_v = queries.lexical_idx[qi], queries.lexical_val[qi]
    learned = _sparse_pairs(ql_i, ql_v, store.learned_idx[safe], store.learned_val[safe])
    lexical = _sparse_pairs(qf_i, qf_v, store.lexical_idx[safe], store.lexical_val[safe])
    ps = torch.stack([dense, learned, lexical], dim=-1)
    nq = torch.stack([torch.linalg.vector_norm(q_dense, dim=-1),
                      torch.linalg.vector_norm(ql_v.double(), dim=-1),
                      torch.linalg.vector_norm(qf_v.double(), dim=-1)], dim=-1)
    nd = torch.stack([torch.linalg.vector_norm(d_dense, dim=-1),
                      torch.linalg.vector_norm(store.learned_val[safe].double(), dim=-1),
                      torch.linalg.vector_norm(store.lexical_val[safe].double(), dim=-1)], dim=-1)
    live = (ids >= 0)[..., None]
    return torch.where(live, ps, 0.0), torch.where(live, nq[:, None, :] * nd, 0.0)


# ---------------------------------------------------------------------------
# brute force
# ---------------------------------------------------------------------------


def _bag_table(idx: torch.Tensor, val: torch.Tensor, vocab: int) -> torch.Tensor:
    """(vocab + 1, B) table: column b holds query b's sparse values by term;
    row ``vocab`` stays 0 for PAD slots."""
    b = idx.shape[0]
    table = torch.zeros((vocab + 1, b), dtype=torch.float32, device=idx.device)
    rows = torch.where(idx >= 0, idx, vocab).long()
    cols = torch.arange(b, device=idx.device)[:, None].expand_as(rows)
    table.index_put_((rows, cols), torch.where(idx >= 0, val.float(), 0.0), accumulate=True)
    return table


def _bag(idx: torch.Tensor, val: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """(M, P) stored ELL rows against a query table -> (M, B) scores."""
    vocab = table.shape[0] - 1
    safe = torch.where(idx >= 0, idx, vocab).long()
    w = torch.where(idx >= 0, val.float(), 0.0)
    return F.embedding_bag(safe, table, per_sample_weights=w, mode="sum")


def _merge_top(best_s, best_i, s, i, k: int):
    """Keep the k largest of two (R, *) candidate sets; ties to the lower id."""
    if best_s is not None:
        s = torch.cat([best_s, s], 1)
        i = torch.cat([best_i, i], 1)
    # order by id first, then a stable sort by score: equal scores keep id order
    o = torch.argsort(i, dim=1, stable=True)
    s, i = torch.gather(s, 1, o), torch.gather(i, 1, o)
    o = torch.sort(s, dim=1, descending=True, stable=True).indices[:, :k]
    return torch.gather(s, 1, o), torch.gather(i, 1, o)


def _chunk_top(s: torch.Tensor, start: int, k: int):
    """Top k columns of (R, M) chunk scores, as (scores, global ids)."""
    k = min(k, s.shape[1])
    top, pos = torch.topk(s, k, dim=1)
    return top, pos + start


def effective_weights(rows: FusionRows, stats: PathStats | None) -> np.ndarray:
    """Weights whose weighted sum ranks a row as its mode does (zscore: the
    weights over the stds; its offsets do not change the order)."""
    w = rows.weights.copy()
    z = np.asarray([m == ZSCORE for m in rows.mode])
    if z.any():
        std = np.maximum(stats.std.numpy(), STD_FLOOR)
        w[z] = w[z] / std
    return w


def exact_topk(queries: Rows, store: Store, alive: torch.Tensor, rows: FusionRows,
               vocab: tuple, k: int = 10, stats: PathStats | None = None):
    """Each row's exact top k eligible doc ids (R, k), PAD where fewer are
    eligible. Scores in fp32 from the stored values."""
    dev = store.dense.device
    uq, inv = np.unique(rows.query, return_inverse=True)
    qsel = torch.as_tensor(uq, device=dev).long()
    qd = queries.dense[qsel].float()
    t_learned = _bag_table(queries.learned_idx[qsel], queries.learned_val[qsel], vocab[0])
    t_lexical = _bag_table(queries.lexical_idx[qsel], queries.lexical_val[qsel], vocab[1])
    col = torch.as_tensor(inv, device=dev).long()
    kw = torch.as_tensor(rows.keyword, device=dev).long()
    has_kw = kw >= 0
    t_kw = torch.zeros((vocab[1] + 1, len(kw)), dtype=torch.float32, device=dev)
    t_kw[torch.where(has_kw, kw, vocab[1]), torch.arange(len(kw), device=dev)] = 1.0
    t_kw[vocab[1]] = 0.0
    w = torch.as_tensor(effective_weights(rows, stats), dtype=torch.float32, device=dev)
    rrf = torch.as_tensor([m == RRF for m in rows.mode], device=dev)
    wr, rr = torch.nonzero(~rrf).flatten(), torch.nonzero(rrf).flatten()
    best = [None, None]
    lists = [[None, None] for _ in range(3)]
    for s in range(0, store.n, _DOC_CHUNK):
        sel = slice(s, s + _DOC_CHUNK)
        dense = store.dense_rows(sel, torch.float32) @ qd.T  # (M, Q')
        learned = _bag(store.learned_idx[sel], store.learned_val[sel], t_learned)
        lexical = _bag(store.lexical_idx[sel], store.lexical_val[sel], t_lexical)
        paths = [p[:, col].T for p in (dense, learned, lexical)]  # each (R, M)
        hits = _bag(store.lexical_idx[sel], torch.ones_like(store.lexical_val[sel]), t_kw).T
        ok = alive[sel][None, :] & (~has_kw[:, None] | (hits > 0))
        if len(wr):
            fused = sum(w[wr, p, None] * paths[p][wr] for p in range(3))
            fused = torch.where(ok[wr], fused, float("-inf"))
            best = list(_merge_top(*best, *_chunk_top(fused, s, k), k))
        for p in range(3):
            if len(rr):
                sp = torch.where(ok[rr], paths[p][rr], float("-inf"))
                lists[p] = list(_merge_top(*lists[p], *_chunk_top(sp, s, RRF_DEPTH), RRF_DEPTH))
    out = torch.full((len(rows.query), k), PAD, dtype=torch.long, device=dev)
    if len(wr):
        out[wr] = torch.where(torch.isfinite(best[0]), best[1], PAD)
    if len(rr):
        out[rr] = _rrf_top(lists, w[rr].double(), torch.as_tensor(rows.rrf_k, device=dev)[rr], k)
    return out


def _rrf_top(lists, w: torch.Tensor, rrf_k: torch.Tensor, k: int) -> torch.Tensor:
    """Fuse each path's ranked (R, D) list by RRF; top k ids, ties to the
    lower id."""
    ids = torch.cat([torch.where(torch.isfinite(s), i, PAD) for s, i in lists], 1)
    r, d = ids.shape[0], lists[0][1].shape[1]
    rank = torch.arange(d, device=ids.device, dtype=torch.float64)
    contrib = torch.cat([torch.where(torch.isfinite(lists[p][0]),
                                     w[:, p, None] / (rrf_k[:, None] + 1.0 + rank), 0.0)
                         for p in range(3)], 1)
    # sum each id's contributions: sort by id, segment sums
    o = torch.argsort(ids, dim=1, stable=True)
    ids, contrib = torch.gather(ids, 1, o), torch.gather(contrib, 1, o)
    new = torch.ones_like(ids, dtype=torch.bool)
    new[:, 1:] = ids[:, 1:] != ids[:, :-1]
    seg = torch.cumsum(new.long(), 1) - 1
    total = torch.zeros_like(contrib).scatter_add_(1, seg, contrib)
    first = torch.zeros_like(ids).scatter_(1, seg, ids)  # each segment's id (all equal)
    n_seg = seg[:, -1:] + 1
    used = (torch.arange(ids.shape[1], device=ids.device)[None, :] < n_seg) & (first >= 0)
    total = torch.where(used, total, float("-inf"))
    top = _merge_top(None, None, total, first, k)
    return torch.where(torch.isfinite(top[0]), top[1], PAD)


def brute_answers(queries: Rows, store: Store, alive: torch.Tensor, rows: FusionRows,
                  vocab: tuple, k: int, stats: PathStats | None):
    """The reference put in the program's place: exact top-k ids and their
    fused and path scores computed from ``store`` (the controls run it on
    a lower-precision store)."""
    ids = exact_topk(queries, store, alive, rows, vocab, k, stats)
    qi = torch.as_tensor(rows.query, device=ids.device).long()
    ps, _ = path_scores(queries, store, qi, ids)
    fused = fused_scores(ps, rows, stats, ids)
    return ids.cpu().numpy(), fused.float().cpu().numpy(), ps.float().cpu().numpy()


def fused_scores(ps: torch.Tensor, rows: FusionRows, stats: PathStats | None,
                 ids: torch.Tensor) -> torch.Tensor:
    """Fused scores (R, k) from path scores: weighted and zscore rows by
    their formula, RRF rows by the ranks among the row's own ids."""
    dev = ps.device
    w = torch.as_tensor(rows.weights, device=dev)[:, None, :]
    out = (ps * w).sum(-1)
    z = torch.as_tensor([m == ZSCORE for m in rows.mode], device=dev)
    if bool(z.any()):
        mean = stats.mean.to(dev)
        std = torch.clamp(stats.std.to(dev), min=STD_FLOOR)
        out = torch.where(z[:, None], (((ps - mean) / std) * w).sum(-1), out)
    r = torch.as_tensor([m == RRF for m in rows.mode], device=dev)
    if bool(r.any()):
        valid = ids >= 0
        beats = (ps[:, None, :, :] > ps[:, :, None, :]) & valid[:, None, :, None]
        rank = beats.sum(2).double()
        rk = torch.as_tensor(rows.rrf_k, device=dev)[:, None, None]
        out = torch.where(r[:, None], (w / (rk + 1.0 + rank)).sum(-1), out)
    return torch.where(ids >= 0, out, float("-inf"))


# ---------------------------------------------------------------------------
# checking answers
# ---------------------------------------------------------------------------


def check_answers(answers: dict, rows: FusionRows, queries: Rows, store: Store,
                  alive: torch.Tensor, stats: PathStats | None, want: torch.Tensor) -> dict:
    """The numbers ``correct`` compares for search answers.

    ``answers``: ``ids`` (R, k) global ids, ``scores`` (R, k) fused scores,
    ``path_scores`` (R, k, 3) and ``expanded`` (R,) graph nodes expanded, as
    the program returned them, row r answering fusion row r. Returns

    - ``path_gap``: the widest |path score - reference| over the pair's
      rounding scale ||q_p|| ||d_p||;
    - ``score_gap``: the same for the fused score of weighted-sum rows;
    - ``zscore_gap``: the gap of a zscore row's fused score over the scale
      of its sparse terms, sum_p |w_p| (||q_p|| ||d_p|| + |mean_p|) / std_p
      over the learned and lexical paths; only where a row is zscore;
    - counts that must be 0: ``bad_ids`` (out of range, duplicate, or a PAD
      before an id), ``dead_returned``, ``keyword_missed`` (only where a row
      carries a keyword), ``empty_rows``
      (rows that returned nothing where an eligible doc exists), ``order_faults``
      (a fused score above the one before it), ``unexpanded_rows`` (answers
      whose search expanded no node).

    An RRF row's fused score comes from ranks over the candidates the
    program merged, which the reference does not see; its path scores, ids
    and order are checked as every row's are.
    """
    dev = store.dense.device
    n = store.n
    out = dict(path_gap=0.0, score_gap=0.0, bad_ids=0, dead_returned=0, keyword_missed=0,
               empty_rows=0, order_faults=0,
               unexpanded_rows=int((np.asarray(answers["expanded"]) <= 0).sum()))
    if ZSCORE in rows.mode:
        out["zscore_gap"] = 0.0
    ids_all = np.asarray(answers["ids"])
    for s in range(0, ids_all.shape[0], _ROW_CHUNK):
        sl = slice(s, s + _ROW_CHUNK)
        ids = torch.as_tensor(ids_all[sl], device=dev).long()
        scores = torch.as_tensor(np.asarray(answers["scores"][sl]), device=dev).double()
        ps_p = torch.as_tensor(np.asarray(answers["path_scores"][sl]), device=dev).double()
        sub = FusionRows(rows.query[sl], rows.mode[sl], rows.weights[sl], rows.rrf_k[sl],
                         rows.keyword[sl])
        qi = torch.as_tensor(sub.query, device=dev).long()
        valid = (ids >= 0) & (ids < n)
        pad = ids == PAD
        out["bad_ids"] += int(((~valid) & (~pad)).sum())
        after_pad = torch.cumsum(pad.long(), 1) > 0
        out["bad_ids"] += int((valid & after_pad).sum())
        srt = torch.sort(torch.where(valid, ids, -1 - torch.arange(ids.shape[1], device=dev)),
                         dim=1).values
        out["bad_ids"] += int((srt[:, 1:] == srt[:, :-1]).sum())
        ids = torch.where(valid, ids, PAD)
        safe = ids.clamp(min=0)
        out["dead_returned"] += int((valid & ~alive[safe]).sum())
        kw = torch.as_tensor(sub.keyword, device=dev).long()
        holds = (store.lexical_idx[safe].long() == kw[:, None, None]).any(-1)
        out["keyword_missed"] += int((valid & (kw[:, None] >= 0) & ~holds).sum())
        out["empty_rows"] += int((~valid.any(1) & (want[sl] >= 0).any(1).to(dev)).sum())
        nxt = valid[:, 1:] & valid[:, :-1]
        out["order_faults"] += int((nxt & (scores[:, 1:] > scores[:, :-1])).sum())

        ps_r, scale = path_scores(queries, store, qi, ids)
        gap = (ps_p - ps_r).abs() / torch.clamp(scale, min=1e-6)
        out["path_gap"] = max(out["path_gap"], float(torch.where(valid[..., None], gap, 0).max()))
        w = torch.as_tensor(sub.weights, device=dev)[:, None, :]
        z = torch.as_tensor([m == ZSCORE for m in sub.mode], device=dev)[:, None]
        rrf = torch.as_tensor([m == RRF for m in sub.mode], device=dev)[:, None]
        if stats is not None:
            mean = stats.mean.to(dev)
            std = torch.clamp(stats.std.to(dev), min=STD_FLOOR)
        else:
            mean = torch.zeros(3, dtype=torch.float64, device=dev)
            std = torch.ones(3, dtype=torch.float64, device=dev)
        fused_r = torch.where(z, (((ps_r - mean) / std) * w).sum(-1), (ps_r * w).sum(-1))
        # a zscore row's dense term sits far from 0 ((s - mean) / std with the
        # tiny std of near-unit dense norms); the sparse terms set its scale
        z_scale = ((scale + mean.abs()) / std * w.abs())[..., 1:].sum(-1)
        f_scale = torch.where(z, z_scale, (scale * w.abs()).sum(-1))
        fgap = (scores - fused_r).abs() / torch.clamp(f_scale, min=1e-6)
        out["score_gap"] = max(out["score_gap"],
                               float(torch.where(valid & ~rrf & ~z, fgap, 0).max()))
        if "zscore_gap" in out:
            out["zscore_gap"] = max(out["zscore_gap"],
                                    float(torch.where(valid & z, fgap, 0).max()))
    if not (rows.keyword >= 0).any():
        del out["keyword_missed"]
    return out


# ---------------------------------------------------------------------------
# checking the search rounds' top-k selections
# ---------------------------------------------------------------------------


def candidate_scores(queries: Rows, store: Store, ids: torch.Tensor, weights: torch.Tensor):
    """Float64 weighted-sum scores (B, C) of query b (row b of ``queries``)
    against its candidate rows ``ids`` (-inf where an id is PAD or out of
    range), and each pair's rounding scale sum_p |w_p| ||q_p|| ||d_p||."""
    qi = torch.arange(ids.shape[0], device=ids.device)
    valid = (ids >= 0) & (ids < store.n)
    ps, scale = path_scores(queries, store, qi, torch.where(valid, ids, PAD))
    w = weights.to(ps.device, torch.float64)
    s = torch.where(valid, (ps * w).sum(-1), float("-inf"))
    return s, (scale * w.abs()).sum(-1)


def stable_topk(s: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest of each row and their positions, ties to the lowest
    position (the rule of DESIGN.md §10); (-inf, PAD) where a row has fewer
    than k finite scores."""
    top, pos = torch.sort(s, dim=1, descending=True, stable=True)
    top, pos = top[:, :k], pos[:, :k]
    return top, torch.where(torch.isfinite(top), pos, PAD)


def check_topk(calls: list, queries: Rows, store: Store, weights: np.ndarray,
               control: Store | None = None) -> dict:
    """The numbers ``correct`` compares for the fused top-k selections of a
    search's rounds, each held against the reference's top k of the same
    candidates.

    ``calls``: (ids (B, C), k, bias, scores (B, k), positions (B, k)) as the
    program's ``fused_topk_vs_ids`` took and returned them, query b being row
    b of ``queries``; ``weights`` the rows' fusion weights (3,). Under
    ``control`` the reference's own selection on that store stands in for
    the program's. Returns

    - ``topk_gap``: the widest gap, over the pair's rounding scale, of a
      kept candidate's score from the reference's, or of a kept candidate
      the reference would not keep below the reference's k-th score;
    - ``topk_faults``: positions out of range, on a PAD candidate, repeated,
      or after an empty slot; rows keeping another count than min(k, live
      candidates); scores rising down a row; equal scores out of position
      order; a candidate kept over one of the same reference score at a
      lower position; and a non-zero bias (no cell takes the KG path).
    """
    out = dict(topk_gap=0.0, topk_faults=0)
    w = torch.as_tensor(weights, dtype=torch.float64)
    for ids_all, k, bias, scores_all, pos_all in calls:
        dev = store.dense.device
        for s0 in range(0, ids_all.shape[0], _ROW_CHUNK):
            sl = slice(s0, s0 + _ROW_CHUNK)
            ids = ids_all[sl].to(dev).long()
            sub = queries.rows(torch.arange(s0, s0 + ids.shape[0], device=dev))
            s, fscale = candidate_scores(sub, store, ids, w)
            b, c = s.shape
            if control is None:
                scores = scores_all[sl].to(dev).double()
                pos = pos_all[sl].to(dev).long()
                if bias is not None:
                    out["topk_faults"] += int((bias[sl] != 0).sum())
            else:
                scores, pos = stable_topk(candidate_scores(sub, control, ids, w)[0], k)
            kept = pos >= 0
            safe = pos.clamp(0, c - 1)
            live = torch.isfinite(s)
            bad = kept & ((pos >= c) | ~torch.gather(live, 1, safe))
            out["topk_faults"] += int(bad.sum())
            out["topk_faults"] += int((kept & (torch.cumsum((~kept).long(), 1) > 0)).sum())
            srt = torch.sort(torch.where(kept, pos, -1 - torch.arange(pos.shape[1], device=dev)),
                             dim=1).values
            out["topk_faults"] += int((srt[:, 1:] == srt[:, :-1]).sum())
            want_n = torch.clamp(live.sum(1), max=k)
            out["topk_faults"] += int((kept.sum(1) - want_n).abs().sum())
            pair = kept[:, 1:] & kept[:, :-1]
            out["topk_faults"] += int((pair & (scores[:, 1:] > scores[:, :-1])).sum())
            out["topk_faults"] += int((pair & (scores[:, 1:] == scores[:, :-1])
                                       & (pos[:, 1:] < pos[:, :-1])).sum())
            good = kept & ~bad
            ar = torch.arange(b, device=dev)[:, None]
            mine = torch.zeros((b, c), dtype=torch.bool, device=dev)
            mine[ar.expand_as(pos)[good], pos[good]] = True
            ref_top, ref_pos = stable_topk(s, k)
            theirs = torch.zeros((b, c), dtype=torch.bool, device=dev)
            rk = ref_pos >= 0
            theirs[ar.expand_as(ref_pos)[rk], ref_pos[rk]] = True
            extra, missing = mine & ~theirs, theirs & ~mine
            tied = (s[:, :, None] == s[:, None, :]) & missing[:, None, :]
            out["topk_faults"] += int((extra & tied.any(-1)).sum())
            fs = torch.clamp(fscale, min=1e-6)
            gap = (scores - torch.gather(s, 1, safe)).abs() / torch.gather(fs, 1, safe)
            gap = torch.where(good, gap, 0.0)
            kth = torch.where(rk, ref_top, float("inf")).min(1).values
            below = (kth[:, None] - s) / fs
            below = torch.where(extra & torch.isfinite(kth)[:, None], below, 0.0)
            out["topk_gap"] = max(out["topk_gap"], float(gap.max()), float(below.max()))
    return out


# ---------------------------------------------------------------------------
# checking a sealed segment
# ---------------------------------------------------------------------------


def self_scores(store: Store) -> torch.Tensor:
    """score(d, d) of every stored row, float64."""
    out = (store.learned_val.double() ** 2).sum(-1) + (store.lexical_val.double() ** 2).sum(-1)
    for s in range(0, store.n, _DOC_CHUNK):
        sel = slice(s, s + _DOC_CHUNK)
        out[sel] += (store.dense_rows(sel) ** 2).sum(-1)
    return out


def check_segment(seg: dict, docs: Rows, gids: np.ndarray, want: Store) -> dict:
    """The numbers ``correct`` compares for one sealed segment.

    ``seg`` holds the segment's leaves as the program built them (host or
    device tensors): ``dense_q``, ``dense_scale``, ``learned_val``,
    ``lexical_val``, ``learned_idx``, ``lexical_idx``, ``semantic_edges``,
    ``keyword_edges``, ``entry_points``, ``self_ip``, ``alive``,
    ``global_ids``. ``docs`` are the rows it was built from, ``want`` their
    int8 storage as the reference works it out. Returns

    - ``int8_step``: the widest difference of a stored int8 value from the
      reference's, in int8 steps;
    - ``scale_gap``: the widest relative gap of a row scale;
    - ``value_gap``: the widest gap of a stored fp16 sparse value, over the
      value;
    - ``self_gap``: the widest relative gap of a self score (fp32 rows);
    - ``graph_faults``: edges out of range, self edges, duplicate edges,
      nodes without a semantic edge, entry points out of range;
    - ``layout_faults``: global ids, alive mask or ELL ids not as given.
    """
    dev = docs.dense.device
    g = {k: torch.as_tensor(v).to(dev) for k, v in seg.items()}
    n = docs.n
    out = {}
    out["int8_step"] = float((g["dense_q"].int() - want.dense.int()).abs().max())
    out["scale_gap"] = float(((g["dense_scale"].double() - want.scale.double()).abs()
                              / want.scale.double()).max())
    vg = 0.0
    for key, ref in (("learned_val", want.learned_val), ("lexical_val", want.lexical_val)):
        diff = (g[key].double() - ref.double()).abs() / torch.clamp(ref.double().abs(), min=1e-6)
        vg = max(vg, float(diff.max()))
    out["value_gap"] = vg
    sref = self_scores(store_fp32(docs))
    out["self_gap"] = float(((g["self_ip"].double() - sref).abs() / sref).max())

    faults = 0
    for key in ("semantic_edges", "keyword_edges"):
        e = g[key].long()
        live = e >= 0
        faults += int(((e < PAD) | (e >= n)).sum())
        faults += int((e == torch.arange(n, device=dev)[:, None]).sum())
        srt = torch.sort(torch.where(live, e, -1 - torch.arange(e.shape[1], device=dev)),
                         dim=1).values
        faults += int((srt[:, 1:] == srt[:, :-1]).sum())
        if key == "semantic_edges":
            faults += int((~live.any(1)).sum())
    ep = g["entry_points"].long()  # may repeat a node: the search dedups its entry set
    faults += int(((ep < 0) | (ep >= n)).sum())
    out["graph_faults"] = faults
    layout = int((g["global_ids"].long().cpu() != torch.as_tensor(gids).long()).sum())
    layout += int((~g["alive"].bool()).sum())
    layout += int((g["learned_idx"] != docs.learned_idx).sum())
    layout += int((g["lexical_idx"] != docs.lexical_idx).sum())
    out["layout_faults"] = layout
    return out


def knn_recall(knn_ids: torch.Tensor, docs: Rows, sample: torch.Tensor, k: int) -> float:
    """Share of each sampled node's exact k nearest rows (by fp32 hybrid
    score, the node itself left out) that the kNN graph holds."""
    store = store_fp32(docs)
    q = docs.rows(sample)
    vocab = (int(torch.cat([docs.learned_idx.max()[None], q.learned_idx.max()[None]]).max()) + 1,
             int(torch.cat([docs.lexical_idx.max()[None], q.lexical_idx.max()[None]]).max()) + 1)
    t_l = _bag_table(q.learned_idx, q.learned_val, vocab[0])
    t_f = _bag_table(q.lexical_idx, q.lexical_val, vocab[1])
    best = (None, None)
    ar = torch.arange(len(sample), device=sample.device)
    for s in range(0, store.n, _DOC_CHUNK):
        sel = slice(s, s + _DOC_CHUNK)
        sc = (store.dense[sel].float() @ q.dense.float().T
              + _bag(store.learned_idx[sel], store.learned_val[sel], t_l)
              + _bag(store.lexical_idx[sel], store.lexical_val[sel], t_f)).T
        own = (sample >= s) & (sample < s + sc.shape[1])
        sc[ar[own], (sample[own] - s).long()] = float("-inf")
        best = _merge_top(*best, *_chunk_top(sc, s, k), k)
    truth = best[1]
    got = knn_ids[sample].long()
    hits = (got[:, :, None] == truth[:, None, :]).any(-1).sum()
    return float(hits) / float(truth.numel())
