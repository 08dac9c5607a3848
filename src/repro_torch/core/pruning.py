"""RNG-IP joint edge pruning + keyword-aware neighbor recycling
(paper §4.1 Steps 2-3, §3.3, Algorithm 1 lines 5-17).
Port of ``repro/core/pruning.py``; ``repro`` vmaps ``_prune_node`` over
nodes, here every function takes a leading node axis C.

Phase 1 (RNG): re-rank each node's candidates by detourable-route count.
Phase 2 (IP): walking that order, v joins the kept set only if
IP(w, v) < IP(v, v) for every already-kept w (a K-step loop over the chunk).
Keyword recycling: a pruned v becomes a keyword edge iff it carries a
keyword of K(u) that no kept neighbor covers.
Final edges: d/4 IP-kept + d/4 reverse + d/2 single-path neighbors.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch import obs
from repro_torch.core.knn_graph import reverse_neighbors
from repro_torch.core.usms import PAD_IDX, FusedVectors, PathWeights, weighted_query
from repro_torch.kernels import ops
from repro_torch.runtime import dispatch

NEG = -1e30
_INT32_MAX = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class PruneConfig:
    degree: int = 16  # final semantic degree d
    keyword_degree: int = 8  # keyword-edge slots per node
    node_chunk: int = 1024
    use_kernel: bool | None = None  # None -> kernel on CUDA tensors; False -> plain
    mode: str = "joint"  # joint | rng (no IP rule) | ip (no detour ordering)


def _argsort(x: torch.Tensor) -> torch.Tensor:
    return torch.sort(x, dim=-1, stable=True)[1]


def _wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """Two's-complement int32 wrap of an int64 tensor: ``repro`` computes the
    RNG rank key in int32, where INT32_MAX * K wraps negative."""
    return ((x + 2**31) % 2**32) - 2**31


def detour_counts(cand_scores: torch.Tensor, pair_scores: torch.Tensor) -> torch.Tensor:
    """cand_scores (C, K) sim(u, v_j) sorted desc; pair_scores (C, K, K)
    sim(v_i, v_j). Returns (C, K) detourable-route counts."""
    k = cand_scores.shape[-1]
    i_lt_j = torch.ones((k, k), dtype=torch.bool, device=cand_scores.device).triu(1)
    detour = i_lt_j & (pair_scores > cand_scores[:, None, :])
    return detour.sum(dim=1).to(torch.int32)


def ip_keep_scan(
    order: torch.Tensor,  # (C, K) candidate positions in keep-priority order
    pair_scores: torch.Tensor,  # (C, K, K)
    self_scores: torch.Tensor,  # (C, K) IP(v, v)
    valid: torch.Tensor,  # (C, K)
    cap: int,
) -> torch.Tensor:
    """Sequential IP keep rule -> (C, K) kept mask in candidate positions:
    K steps, each on the whole chunk."""
    c, k = order.shape
    rows = torch.arange(c, device=order.device)
    kept = torch.zeros((c, k), dtype=torch.bool, device=order.device)
    n_kept = torch.zeros((c,), dtype=torch.int32, device=order.device)
    neg = torch.full((c, k), NEG, dtype=pair_scores.dtype, device=order.device)
    for j in range(k):
        v = order[:, j]
        ips = pair_scores[rows, :, v]  # (C, K): IP(w, v) for every w
        ips_vs_kept = torch.where(kept, ips, neg)
        ok = (
            (ips_vs_kept < self_scores[rows, v][:, None]).all(-1)
            & (n_kept < cap)
            & valid[rows, v]
        )
        kept[rows, v] = ok
        n_kept = n_kept + ok.to(torch.int32)
    return kept


def keyword_flags(u_kw: torch.Tensor, cand_kw: torch.Tensor, kept: torch.Tensor) -> torch.Tensor:
    """Dual-assessment recycle flags. u_kw (C, Pf), cand_kw (C, K, Pf),
    kept (C, K) -> (C, K): v (not kept) is flagged iff some keyword in
    K(u) ∩ K(v) is absent from every kept neighbor. The (C, K, Pf, K, Pf)
    compare is bounded by ``node_chunk``."""
    in_u = (cand_kw[:, :, :, None] == u_kw[:, None, None, :]).any(-1) & (cand_kw >= 0)
    eq = cand_kw[:, :, :, None, None] == cand_kw[:, None, None, :, :]  # (C, K, Pf, K, Pf)
    covered = (eq.any(-1) & kept[:, None, None, :]).any(-1)  # (C, K, Pf)
    return (in_u & ~covered).any(-1) & ~kept


def unique_take(ids: torch.Tensor, scores: torch.Tensor, width: int) -> torch.Tensor:
    """Stable first-occurrence unique over priority-ordered id lists
    (..., L), padded to ``width`` with PAD_IDX. ``repro`` returns only
    min(L, width) entries; this follows its docstring and pads."""
    l = ids.shape[-1]
    ar = torch.arange(l, device=ids.device)
    earlier_same = (ids[..., :, None] == ids[..., None, :]) & (ar[None, :] < ar[:, None])
    is_dup = earlier_same.any(-1) | (ids == PAD_IDX) | ~torch.isfinite(scores)
    rank = torch.where(is_dup, l + ar, ar)
    sorted_rank, order = torch.sort(rank, dim=-1, stable=True)
    out = torch.where(sorted_rank < l, torch.gather(ids, -1, order), torch.full_like(ids, PAD_IDX))
    if l < width:
        pad = torch.full(out.shape[:-1] + (width - l,), PAD_IDX, dtype=out.dtype, device=out.device)
        out = torch.cat([out, pad], dim=-1)
    return out[..., :width]


def _take_first(rank: torch.Tensor, ids: torch.Tensor, width: int) -> torch.Tensor:
    """ids ordered by ascending ``rank`` (stable), +inf ranks -> PAD, cut to
    ``width``: the kept/keyword list assembly of ``repro``'s _prune_node."""
    sorted_rank, order = torch.sort(rank, dim=-1, stable=True)
    out = torch.where(sorted_rank < float("inf"), torch.gather(ids, -1, order),
                      torch.full_like(ids, PAD_IDX))
    return out[..., :width]


def _prune_nodes(
    node_ids: torch.Tensor,  # (C,) node ids (self-edges masked)
    cand_ids: torch.Tensor,  # (C, K) candidate ids sorted by fused score desc
    cand_scores: torch.Tensor,  # (C, K) sim(u, v)
    pair_scores: torch.Tensor,  # (C, K, K)
    cand_self: torch.Tensor,  # (C, K) IP(v, v)
    path_picks: torch.Tensor,  # (C, 3, pk) single-path neighbor ids
    u_kw: torch.Tensor,  # (C, Pf)
    cand_kw: torch.Tensor,  # (C, K, Pf)
    rev_ids: torch.Tensor,  # (C, R)
    cfg: PruneConfig,
):
    """``repro``'s ``_prune_node``, batched over the node axis C."""
    d = cfg.degree
    d4 = max(d // 4, 1)
    c, k = cand_ids.shape
    dev = cand_ids.device
    pad_c = torch.full_like(cand_ids, PAD_IDX)
    cand_ids = torch.where(cand_ids == node_ids[:, None], pad_c, cand_ids)
    path_picks = torch.where(path_picks == node_ids[:, None, None],
                             torch.full_like(path_picks, PAD_IDX), path_picks)
    valid = cand_ids >= 0
    inf = torch.full_like(cand_scores, float("inf"))

    # --- phase 1: RNG ordering by detourable routes ---
    if cfg.mode == "ip":
        order = _argsort(torch.where(valid, -cand_scores, inf))
    else:
        routes = detour_counts(cand_scores, pair_scores).long()
        routes = torch.where(valid, routes, torch.full_like(routes, _INT32_MAX))
        key = _wrap_int32(routes * k + torch.arange(k, device=dev))
        order = _argsort(key)

    # --- phase 2: IP keep rule ---
    if cfg.mode == "rng":
        kept = torch.zeros((c, k), dtype=torch.bool, device=dev)
        kept.scatter_(1, order[:, :d4], True)
        kept &= valid
    else:
        kept = ip_keep_scan(order, pair_scores, cand_self, valid, d4)

    # --- keyword recycling flags (dual assessment) ---
    flags = keyword_flags(u_kw, cand_kw, kept) & valid

    # --- assemble final semantic edges ---
    kept_ids = _take_first(torch.where(kept, -cand_scores, inf), cand_ids, d4)
    rev_top = rev_ids[:, :d4]
    d_rem = d - 2 * d4
    per_path = max(d_rem // 3, 1)
    # interleave per-path picks (dense, sparse, full, dense, ...)
    picks = path_picks[:, :, :per_path].transpose(1, 2).reshape(c, -1)
    priority = torch.cat([kept_ids, rev_top, picks, cand_ids], dim=1)
    sem = unique_take(priority, torch.zeros(priority.shape, device=dev), d)

    # --- keyword edges from flagged pruned candidates ---
    kw = _take_first(torch.where(flags, -cand_scores, inf), cand_ids, cfg.keyword_degree)
    return sem, kw, flags


def _prune_chunk(
    corpus: FusedVectors,
    chunk_queries: FusedVectors,
    node_ids: torch.Tensor,  # (C,) ids of the nodes being pruned
    cand_ids: torch.Tensor,  # (C, K)
    cand_scores: torch.Tensor,  # (C, K)
    corpus_self: torch.Tensor,  # (N,) IP(v, v) for all nodes
    rev_ids: torch.Tensor,  # (C, R)
    path_ids: torch.Tensor | None,  # (C, 3, pk) per-path neighbor ids or None
    cfg: PruneConfig,
):
    """Prune one node chunk. The (C, K, K) pair tiles come from the
    pairwise-tile kernel, which gathers each node's K rows by id once."""
    n = corpus.n
    pair = ops.pairwise_tile_scores_vs_ids(corpus, cand_ids, use_kernel=cfg.use_kernel)
    if path_ids is None:
        # fallback (no per-path refinement): rerank the fused pool per path
        pk = max((cfg.degree - 2 * max(cfg.degree // 4, 1)) // 3, 1)
        paths = []
        for w in (PathWeights.make(1.0, 0.0, 0.0), PathWeights.make(0.0, 1.0, 0.0),
                  PathWeights.make(0.0, 0.0, 1.0)):
            qw = weighted_query(chunk_queries, w)
            _, pos = ops.fused_topk_vs_ids(qw, corpus, cand_ids, pk, use_kernel=cfg.use_kernel)
            paths.append(ops.take_topk_ids(cand_ids, pos))
        path_ids = torch.stack(paths, dim=1)  # (C, 3, pk)
    # invalid candidates j score -inf (columns only, as repro)
    pair = torch.where(cand_ids[:, None, :] >= 0, pair, torch.full_like(pair, float("-inf")))
    safe = cand_ids.clamp(0, n - 1).long()
    cand_self = torch.where(cand_ids >= 0, corpus_self[safe],
                            torch.full(cand_ids.shape, NEG, device=cand_ids.device))
    cand_kw = corpus.lexical.idx[safe]
    cand_kw = torch.where(cand_ids[..., None] >= 0, cand_kw, torch.full_like(cand_kw, PAD_IDX))
    return _prune_nodes(
        node_ids, cand_ids, cand_scores, pair, cand_self, path_ids,
        chunk_queries.lexical.idx, cand_kw, rev_ids, cfg,
    )


def self_scores(corpus: FusedVectors, use_kernel: bool | None = None) -> torch.Tensor:
    """IP(v, v), the fused self-similarity: the distance kernel with
    ids = arange(N)[:, None] (no second copy of the corpus)."""
    ids = torch.arange(corpus.n, dtype=torch.int32, device=corpus.device)[:, None]
    return ops.hybrid_scores_vs_ids(corpus, corpus, ids, use_kernel=use_kernel)[:, 0]



def prune_all(
    corpus: FusedVectors,
    knn_ids: torch.Tensor,
    knn_scores: torch.Tensor,
    cself: torch.Tensor,
    path_ids: torch.Tensor | None,
    cfg: PruneConfig,
) -> tuple[torch.Tensor, torch.Tensor]:
    """RNG-IP pruning over node chunks, given the self scores (the build
    pipeline's stages 2-3); span ``build.prune.chunk`` per chunk."""
    n = corpus.n
    rev = reverse_neighbors(knn_ids, max(cfg.degree // 4, 1))
    node_ids = torch.arange(n, dtype=torch.int32, device=knn_ids.device)
    sems, kws = [], []
    for s in range(0, n, cfg.node_chunk):
        e = min(s + cfg.node_chunk, n)
        with obs.span("build.prune.chunk", start=s):
            sem, kw, _ = _prune_chunk(corpus, corpus[s:e], node_ids[s:e], knn_ids[s:e],
                                      knn_scores[s:e], cself, rev[s:e],
                                      None if path_ids is None else path_ids[s:e], cfg)
        sems.append(sem)
        kws.append(kw)
    return torch.cat(sems), torch.cat(kws)


def rng_ip_prune(
    corpus: FusedVectors,
    knn_ids: torch.Tensor,  # (N, K) NN-Descent output, score-sorted desc
    knn_scores: torch.Tensor,  # (N, K)
    cfg: PruneConfig,
    *,
    path_ids: torch.Tensor | None = None,  # (N, 3, pk) per-path neighbors
) -> tuple[torch.Tensor, torch.Tensor]:
    """The full pruning pass, host-driven (``repro``'s legacy path): self
    scores, then ``prune_all``. Returns (semantic_edges (N, d),
    keyword_edges (N, dk)). Counts one dispatch, for the self scores;
    ``repro`` also counts one per node chunk."""
    dispatch.tick()
    cself = self_scores(corpus, use_kernel=cfg.use_kernel)
    return prune_all(corpus, knn_ids, knn_scores, cself, path_ids, cfg)
