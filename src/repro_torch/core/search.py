"""Flexible query processing on the hybrid index (paper §4.2, Algorithm 2).
Port of ``repro/core/search.py``.

``repro`` vmaps ``_search_one`` over the batch under a ``fori_loop``; here
the beam search runs on (B, ...) tensors in a Python loop of ``iters``
rounds. Each round expands the ``expand`` best unvisited pool entries, loads
their semantic (and, when asked, keyword and logical) edges, dedups against
the pool and the visited ring, and scores + selects the round's candidates
with one ``fused_topk`` launch (plus one for the twin keyword pool). The
final pool is re-scored per path with one ``hybrid_distance`` launch and
fused by the ``FusionSpec`` mode. An index whose corpus is in int8 storage
(``QuantizedFusedVectors``) runs the same loop through the kernels'
``has_scale`` variants.

Under an active ``obs.tracing`` context a call records the spans ``search``
> ``search.entry``, ``iters`` x ``search.round`` (> ``search.select``,
``search.gather``, ``search.dedup``, ``search.score``, ``search.merge``,
``search.twin_pool`` with keywords) and ``search.final`` (> ``search.filter``,
``search.rescore``, ``search.fuse``), and the counters ``search.rounds``,
``search.edge_slots`` (B x W a round, W the round's candidate slots) and
``search.fresh_candidates`` (slots left after the dedup, summed on the
device). DESIGN.md §12.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from repro_torch import obs
from repro_torch.core.fusion import (
    FUSION_MODE_NAMES,
    FusionSpec,
    as_fusion_spec,
    broadcast_spec,
    fuse_candidates,
)
from repro_torch.core.index import HybridIndex
from repro_torch.core.knn_graph import dedup_mask
from repro_torch.core.usms import (
    PAD_IDX,
    FusedVectors,
    PathWeights,
    SparseVec,
    has_keyword_overlap,
    weighted_query,
)
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.ref import topk_desc

NEG = -1e30
INF_HOP = 10**6


@dataclasses.dataclass(frozen=True)
class SearchParams:
    k: int = 10
    iters: int = 48  # expansion rounds (search breadth ~ iters * expand)
    pool_size: int = 64  # primary candidate pool
    kw_pool_size: int = 16  # twin pool for keyword-satisfying overflow
    expand: int = 1  # nodes expanded per round
    use_kernel: bool | None = None  # None -> kernel on CUDA tensors; False -> plain
    use_keywords: bool = False  # keyword edge loading + filtering
    use_kg: bool = False  # logical edge traversal
    kg_max_hops: int = 3
    corpus_dtype: str = "float32"  # sealed-corpus storage: "float32" or "int8"
    # (per-row int8 dense + fp16 sparse vals, quantized at seal time; every
    # corpus score, the final per-path re-score included, reads the stored
    # form). It names the storage the index carries, never traced data.


CORPUS_DTYPES = ("float32", "int8")


def resolve_params(params: SearchParams) -> SearchParams:
    """Validate params. ``use_kernel=None`` needs no pinning here: the
    kernel wrappers choose by the device of the tensors they are given."""
    if params.corpus_dtype not in CORPUS_DTYPES:
        raise ValueError(
            f"corpus_dtype must be one of {CORPUS_DTYPES}, got {params.corpus_dtype!r}"
        )
    return params


@dataclasses.dataclass
class SearchResult:
    ids: torch.Tensor  # (B, k) int32
    scores: torch.Tensor  # (B, k) f32 fused scores (mode-dependent scale)
    expanded: torch.Tensor  # (B,) int32 number of expanded nodes
    path_scores: Optional[torch.Tensor] = None  # (B, k, 3) [dense, learned, lexical]
    # replica names whose shards this result is missing (a degraded scatter
    # read, DESIGN.md §9); None for single-index results and healthy tiers
    down_replicas: Optional[tuple] = None


def _full(shape, fill, dtype, device) -> torch.Tensor:
    return torch.full(shape, fill, dtype=dtype, device=device)


def _entry_state(index: HybridIndex, q_entities: torch.Tensor, p: SearchParams,
                 entry_points: Optional[torch.Tensor] = None):
    """Entry points per query: nodes holding the query entities when the KG
    is on, then the precomputed large-norm nodes (Algorithm 2 l.2-8), the
    index's or, when given, one row of ``entry_points`` (B, n_entry) each."""
    b = q_entities.shape[0]
    dev = q_entities.device
    base = index.entry_points[None, :].expand(b, -1) if entry_points is None else entry_points
    base_ent = _full(base.shape, PAD_IDX, torch.int32, dev)
    if p.use_kg:
        n_ent = index.entity_to_docs.shape[0]
        ent_docs = index.entity_to_docs[q_entities.clamp(0, n_ent - 1).long()]  # (B, Eq, M)
        valid_e = (q_entities >= 0)[..., None] & (ent_docs >= 0)
        ent_ids = torch.where(valid_e, ent_docs, PAD_IDX).reshape(b, -1)
        ent_of = torch.where(valid_e, q_entities[..., None], PAD_IDX).reshape(b, -1)
        ids = torch.cat([ent_ids, base], dim=1)
        ents = torch.cat([ent_of, base_ent], dim=1).to(torch.int32)
    else:
        ids, ents = base, base_ent
    ids = ids.to(torch.int32)
    ids = torch.where(dedup_mask(ids), ids, PAD_IDX)
    hops = torch.where(ents >= 0, 0, INF_HOP).to(torch.int32)
    return ids, ents, hops


def _gather(t: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    return torch.gather(t, 1, pos)


def _search_batch(
    index: HybridIndex,
    qw: FusedVectors,  # (B, ...) weight-scaled queries
    q_raw: FusedVectors,  # (B, ...) unweighted queries (per-path re-scoring)
    q_keywords: torch.Tensor,  # (B, Kw) required keyword ids (PAD padded)
    q_entities: torch.Tensor,  # (B, Eq) query entity ids (PAD padded)
    spec: FusionSpec,  # batched (B,) / (B, 3) leaves
    p: SearchParams,
    entry_points: Optional[torch.Tensor] = None,  # (B, n_entry) per-row entry points
):
    """``repro``'s ``_search_one``, batched over the B queries."""
    n = index.n
    P = p.pool_size
    b = qw.n
    dev = qw.device
    i32 = torch.int32
    corpus = index.corpus
    w_kg = spec.weights.kg  # (B,)

    traced = obs.active() is not None  # counter operands only then

    # ---- init pool ---------------------------------------------------------
    with obs.span("search.entry"):
        e_ids, e_ents, e_hops = _entry_state(index, q_entities, p, entry_points)
        ne = e_ids.shape[1]
        if ne > P:
            raise ValueError("pool_size must cover the entry set")
        e_scores = ops.hybrid_scores_vs_ids(qw, corpus, e_ids, use_kernel=p.use_kernel)
        e_scores = torch.where(e_ids >= 0, e_scores, NEG)
        if p.use_kg:  # entity-matched entry points get the full hop-0 reward
            e_scores = torch.where((e_ents >= 0) & (e_ids >= 0), e_scores + w_kg[:, None],
                                   e_scores)
        padw = P - ne
        pool_ids = torch.cat([e_ids, _full((b, padw), PAD_IDX, i32, dev)], 1)
        pool_scores = torch.cat([e_scores, _full((b, padw), NEG, torch.float32, dev)], 1)
        pool_visited = torch.cat([_full((b, ne), False, torch.bool, dev),
                                  _full((b, padw), True, torch.bool, dev)], 1)
        pool_ents = torch.cat([e_ents, _full((b, padw), PAD_IDX, i32, dev)], 1)
        pool_hops = torch.cat([e_hops, _full((b, padw), INF_HOP, i32, dev)], 1)
        E = p.expand
        ring = _full((b, p.iters * E), PAD_IDX, i32, dev)
        kw_ids = _full((b, p.kw_pool_size), PAD_IDX, i32, dev)
        kw_scores = _full((b, p.kw_pool_size), NEG, torch.float32, dev)
        n_expanded = torch.zeros((b,), dtype=i32, device=dev)
    lex_idx = corpus.lexical.idx

    for i in range(p.iters):
        with obs.span("search.round", i=i):
            # ---- pick the E best unvisited candidates (Algorithm 2 l.11) ----
            with obs.span("search.select"):
                sel = torch.where(~pool_visited & (pool_ids >= 0), pool_scores, NEG)
                sel_top, js = topk_desc(sel, E)  # (B, E)
                active = sel_top > NEG
                u = torch.where(active, _gather(pool_ids, js), PAD_IDX)
                u_safe = u.clamp(0, n - 1).long()
                u_ent = _gather(pool_ents, js)
                u_hop = _gather(pool_hops, js)
                pool_visited = pool_visited.scatter(1, js, True)
                ring[:, i * E:(i + 1) * E] = u
                n_expanded = n_expanded + active.sum(1).to(i32)

            # ---- gather neighbor lists (l.13-17, dynamic edge loading) ----
            with obs.span("search.gather"):
                sem = index.semantic_edges[u_safe]  # (B, E, d)
                parts_ids = [sem]
                parts_ents = [torch.full_like(sem, PAD_IDX)]
                if p.use_keywords:
                    shares = has_keyword_overlap(lex_idx[u_safe], q_keywords[:, None, :])  # (B, E)
                    kwe = torch.where(shares[..., None], index.keyword_edges[u_safe], PAD_IDX)
                    parts_ids.append(kwe)
                    parts_ents.append(torch.full_like(kwe, PAD_IDX))
                if p.use_kg:
                    loge = index.logical_edges[u_safe]  # (B, E, L, 4)
                    ok = ((u_ent[..., None] >= 0) & (u_hop[..., None] < p.kg_max_hops)
                          & (loge[..., 1] == u_ent[..., None]) & (loge[..., 0] >= 0))
                    parts_ids.append(torch.where(ok, loge[..., 0], PAD_IDX))
                    parts_ents.append(torch.where(ok, loge[..., 3], PAD_IDX))
                nbr_ids2 = torch.cat(parts_ids, dim=2).to(i32)  # (B, E, W0)
                nbr_log_ents = torch.cat(parts_ents, dim=2).to(i32).reshape(b, -1)
                nbr_ids2 = torch.where(active[..., None], nbr_ids2, PAD_IDX)
                w0 = nbr_ids2.shape[2]
                src_hop = u_hop[..., None].expand(b, E, w0).reshape(b, -1)
                src_ent = u_ent[..., None].expand(b, E, w0).reshape(b, -1)
                nbr_ids = nbr_ids2.reshape(b, -1)

            # ---- dedup vs pool, visited ring, and within the list ----
            with obs.span("search.dedup"):
                dup = (nbr_ids[:, :, None] == pool_ids[:, None, :]).any(-1)
                dup |= (nbr_ids[:, :, None] == ring[:, None, :]).any(-1)
                nbr_ids = torch.where(dup | ~dedup_mask(nbr_ids), PAD_IDX, nbr_ids)
                nbr_safe = nbr_ids.clamp(0, n - 1).long()
            W = nbr_ids.shape[1]
            if traced:
                obs.count("search.rounds", 1)
                obs.count("search.edge_slots", b * W)
                obs.count("search.fresh_candidates", nbr_ids >= 0)

            # ---- the round's scores: KG reward (l.19-20), fused hybrid
            # distance + top-k (l.21-25) ----
            with obs.span("search.score"):
                if p.use_kg:
                    n_ent = index.entity_adj.shape[0]
                    cand_ents = index.doc_entities[nbr_safe]  # (B, W, Ed)
                    src_safe = src_ent.clamp(0, n_ent - 1).long()
                    rel = (index.entity_adj[src_safe[..., None],
                                            cand_ents.clamp(0, n_ent - 1).long()]
                           & (cand_ents >= 0) & (src_ent[..., None] >= 0))  # (B, W, Ed)
                    ed = rel.shape[-1]
                    ar = torch.arange(ed, device=dev)
                    first = torch.where(rel, ar, ed).min(-1).values.clamp(max=ed - 1)  # 1st True
                    sem_match = torch.where(
                        rel.any(-1), torch.gather(cand_ents, 2, first[..., None])[..., 0],
                        PAD_IDX)
                    o_ents = torch.where(nbr_log_ents >= 0, nbr_log_ents, sem_match).to(i32)
                    o_hops = torch.where((o_ents >= 0) & (nbr_ids >= 0),
                                         torch.clamp(src_hop + 1, max=INF_HOP), INF_HOP).to(i32)
                    reward = torch.where(o_hops < INF_HOP,
                                         w_kg[:, None] / torch.clamp(o_hops, min=1).float(), 0.0)
                else:
                    o_ents = torch.full_like(nbr_ids, PAD_IDX)
                    o_hops = torch.full_like(nbr_ids, INF_HOP)
                    reward = torch.zeros(nbr_ids.shape, dtype=torch.float32, device=dev)
                kr = min(P, W)
                sel_scores, sel_pos = ops.fused_topk_vs_ids(
                    qw, corpus, nbr_ids, kr, bias=reward, use_kernel=p.use_kernel)
                sel_ids = ops.take_topk_ids(nbr_ids, sel_pos)
                sel_ents = ops.take_topk(o_ents, sel_pos, PAD_IDX)
                sel_hops = ops.take_topk(o_hops, sel_pos, INF_HOP)

            with obs.span("search.merge"):
                all_ids = torch.cat([pool_ids, sel_ids], 1)
                all_scores = torch.cat([pool_scores, sel_scores], 1)
                all_visited = torch.cat(
                    [pool_visited, torch.zeros_like(sel_ids, dtype=torch.bool)], 1)
                all_ents = torch.cat([pool_ents, sel_ents], 1)
                all_hops = torch.cat([pool_hops, sel_hops], 1)
                top, pos = topk_desc(all_scores, P)
                pool_ids = torch.where(top > NEG, _gather(all_ids, pos), PAD_IDX)
                pool_scores = top
                pool_visited = _gather(all_visited, pos) | (top <= NEG)
                pool_ents = _gather(all_ents, pos)
                pool_hops = _gather(all_hops, pos)

            # ---- twin pool: keyword-satisfying candidates (l.26-28) ----
            if p.use_keywords:
                with obs.span("search.twin_pool"):
                    matches = has_keyword_overlap(lex_idx[nbr_safe], q_keywords[:, None, :])
                    matches &= nbr_ids >= 0
                    in_kw = (nbr_ids[:, :, None] == kw_ids[:, None, :]).any(-1)
                    kw_cand = torch.where(matches & ~in_kw, nbr_ids, PAD_IDX)
                    kk = min(p.kw_pool_size, W)
                    kwsel_scores, kwsel_pos = ops.fused_topk_vs_ids(
                        qw, corpus, kw_cand, kk, bias=reward, use_kernel=p.use_kernel)
                    m_ids = torch.cat([kw_ids, ops.take_topk_ids(kw_cand, kwsel_pos)], 1)
                    m_scores = torch.cat([kw_scores, kwsel_scores], 1)
                    kw_top, kw_pos = topk_desc(m_scores, p.kw_pool_size)
                    kw_ids = torch.where(kw_top > NEG, _gather(m_ids, kw_pos), PAD_IDX)
                    kw_scores = kw_top

    # ---- final results (l.29-30): merge pools, keyword and alive filters --
    with obs.span("search.final"):
        with obs.span("search.filter"):
            res_ids = torch.cat([pool_ids, kw_ids], 1)
            res_scores = torch.cat([pool_scores, kw_scores], 1)
            res_safe = res_ids.clamp(0, n - 1).long()
            valid = dedup_mask(res_ids) & index.alive[res_safe] & (res_ids >= 0)
            res_scores = torch.where(valid, res_scores, NEG)
            if p.use_keywords:
                has_req = (q_keywords >= 0).any(-1)[:, None]
                match = has_keyword_overlap(lex_idx[res_safe], q_keywords[:, None, :])
                valid = valid & ~(has_req & ~match)
                res_scores = torch.where(has_req & ~match, NEG, res_scores)

        # ---- dynamic fusion (§11): re-score the final pool per path, with the
        # three single-path queries stacked into one launch ----
        with obs.span("search.rescore"):
            zd = torch.zeros_like(q_raw.dense)
            lv, fv = q_raw.learned.val, q_raw.lexical.val
            lv0, fv0 = torch.zeros_like(lv), torch.zeros_like(fv)
            q3 = FusedVectors(  # rows: dense-only, learned-only, lexical-only
                torch.cat([q_raw.dense, zd, zd]),
                SparseVec(torch.cat([q_raw.learned.idx] * 3), torch.cat([lv0, lv, lv0])),
                SparseVec(torch.cat([q_raw.lexical.idx] * 3), torch.cat([fv0, fv0, fv])),
            )
            ps3 = ops.hybrid_scores_vs_ids(q3, corpus, res_ids.repeat(3, 1),
                                           use_kernel=p.use_kernel)
            ps = torch.stack([ps3[:b], ps3[b:2 * b], ps3[2 * b:]], dim=-1)  # (B, M, 3)
            ps = torch.where(valid[..., None], ps, 0.0)

        with obs.span("search.fuse"):
            fused = fuse_candidates(res_scores, ps, valid, spec, NEG)
            top, pos = topk_desc(fused, p.k)
            ok = top > NEG
            out_ids = torch.where(ok, _gather(res_ids, pos), PAD_IDX)
            out_ps = torch.where(ok[..., None],
                                 torch.gather(ps, 1, pos[..., None].expand(-1, -1, 3)), 0.0)
    return out_ids, top, out_ps, n_expanded


def search_padded(
    index: HybridIndex,
    queries: FusedVectors,
    fusion: Union[FusionSpec, PathWeights],
    keywords: torch.Tensor,  # (B, Kw) required keywords, PAD_IDX padded
    entities: torch.Tensor,  # (B, Eq) query entities, PAD_IDX padded
    params: SearchParams,
    *,
    entry_points: Optional[torch.Tensor] = None,
) -> SearchResult:
    """Batched search over padded operands, on the index's device. A bare
    ``PathWeights`` means weighted-sum. ``entry_points`` (B, n_entry), when
    given, replaces the index's entry points row by row (a pool group's
    segments searched as one index, ``distributed.make_local_group_search``)."""
    params = resolve_params(params)
    if isinstance(fusion, PathWeights):
        fusion = FusionSpec.from_weights(fusion)
    dev = index.semantic_edges.device
    b = queries.n
    with obs.span("search", B=b, iters=params.iters, pool=params.pool_size,
                  expand=params.expand, corpus_dtype=params.corpus_dtype) as root:
        if root is not None:
            root.annotate(mode=_mode_names(fusion.mode))
        spec = broadcast_spec(fusion, b, dev)
        queries = queries.to(dev)
        qw = weighted_query(queries, spec.weights)
        ids, scores, ps, expanded = _search_batch(
            index, qw, queries, keywords.to(dev, torch.int32), entities.to(dev, torch.int32),
            spec, params, entry_points,
        )
    return SearchResult(ids, scores, expanded, ps)


def _mode_names(mode) -> str:
    """The fusion modes of a spec by name, read where the spec lies on the
    host (a device spec is not read: that would sync)."""
    mode = torch.as_tensor(mode)
    if mode.device.type != "cpu":
        return "unread (on device)"
    return ",".join(FUSION_MODE_NAMES[int(m)] for m in torch.unique(mode).tolist())


def search(
    index: HybridIndex,
    queries: FusedVectors,
    fusion: Union[FusionSpec, PathWeights],
    params: SearchParams,
    *,
    keywords=None,  # (B, Kw) required keywords
    entities=None,  # (B, Eq) query entities
    device=None,
) -> SearchResult:
    """Batched hybrid search with any path combination and fusion mode, on
    ``device`` (``None`` -> CUDA; raises when CUDA is absent). The index
    must already lie on that device."""
    dev = resolve_device(device)
    if index.semantic_edges.device.type != dev.type:
        raise ValueError(f"index lies on {index.semantic_edges.device}, search asked for {dev}")
    spec = as_fusion_spec(fusion)
    b = queries.n

    def as_padded(a):  # fabricate the PAD array only when absent/empty
        if a is None:
            return torch.full((b, 1), PAD_IDX, dtype=torch.int32)
        a = torch.as_tensor(a, dtype=torch.int32)
        return torch.full((b, 1), PAD_IDX, dtype=torch.int32) if a.shape[1] == 0 else a

    return search_padded(index, queries, spec, as_padded(keywords), as_padded(entities), params)
