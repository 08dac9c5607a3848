"""Approximate k-NN graph construction with NN-Descent (paper §4.1 Step 1,
Algorithm 1 lines 1-4). Port of ``repro/core/knn_graph.py``.

Each round explores every node's 2-hop neighborhood: gather (C, K*K) 2-hop
candidate ids + R random ids -> dedup -> fused hybrid score + top-k (the
``fused_topk`` kernel gathers the candidate rows by id) -> merge with the
current neighbors. The builder (``core/build_pipeline.py``) runs it chunk by
chunk over nodes.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.usms import PAD_IDX, FusedVectors
from repro_torch.kernels import ops
from repro_torch.kernels.ref import topk_desc
from repro_torch.runtime import dispatch


@dataclasses.dataclass(frozen=True)
class KnnConfig:
    k: int = 32  # neighbors kept per node during descent
    iters: int = 6
    extra_random: int = 8  # random candidates injected per round (escape lows)
    node_chunk: int = 2048  # nodes scored per fused-top-k launch (memory bound)
    use_kernel: bool | None = None  # None -> kernel on CUDA tensors; False -> plain


def dedup_mask(ids: torch.Tensor) -> torch.Tensor:
    """Mask marking the first occurrence of each id along the last axis
    (PAD_IDX entries always masked out). Any leading batch shape."""
    sorted_ids, order = torch.sort(ids, dim=-1, stable=True)
    first = torch.ones_like(sorted_ids, dtype=torch.bool)
    first[..., 1:] = sorted_ids[..., 1:] != sorted_ids[..., :-1]
    mask_sorted = first & (sorted_ids != PAD_IDX)
    return torch.zeros_like(mask_sorted).scatter(-1, order, mask_sorted)


def _merge_topk(ids_a, scores_a, ids_b, scores_b, k: int):
    """Merge two (.., L) candidate lists into top-k by score with id dedup."""
    ids = torch.cat([ids_a, ids_b], dim=-1)
    scores = torch.cat([scores_a, scores_b], dim=-1)
    keep = dedup_mask(ids)
    scores = torch.where(keep, scores, torch.full_like(scores, float("-inf")))
    top, pos = topk_desc(scores, k)
    out_ids = torch.gather(ids, -1, pos)
    out_ids = torch.where(torch.isfinite(top), out_ids, torch.full_like(out_ids, PAD_IDX))
    return out_ids, top


def _descent_round_chunk(
    corpus: FusedVectors,
    nbr_ids: torch.Tensor,  # (N, K) round-start graph (global)
    chunk_queries: FusedVectors,  # (C, ...) fused vectors of this node chunk
    chunk_node_ids: torch.Tensor,  # (C,)
    chunk_nbrs: torch.Tensor,  # (C, K)
    chunk_scores: torch.Tensor,  # (C, K)
    rand_ids: torch.Tensor,  # (C, R) random candidate injection
    cfg: KnnConfig,
):
    k = cfg.k
    c = chunk_nbrs.shape[0]
    valid = chunk_nbrs >= 0
    two_hop = nbr_ids[chunk_nbrs.clamp(min=0).long()].reshape(c, k * k)
    two_hop = torch.where(valid.repeat_interleave(k, dim=-1), two_hop,
                          torch.full_like(two_hop, PAD_IDX))
    cand = torch.cat([two_hop, rand_ids.to(two_hop.dtype)], dim=-1)
    # never propose the node itself or ids already in the neighbor list
    pad = torch.full_like(cand, PAD_IDX)
    cand = torch.where(cand == chunk_node_ids[:, None], pad, cand)
    already = (cand[:, :, None] == chunk_nbrs[:, None, :]).any(-1)
    cand = torch.where(already, pad, cand)
    cand = torch.where(dedup_mask(cand), cand, pad)
    # fused distance + per-row top-k; pre-selecting k is exact because cand
    # is deduped and disjoint from chunk_nbrs (see repro's note)
    sel_scores, sel_pos = ops.fused_topk_vs_ids(
        chunk_queries, corpus, cand, k, use_kernel=cfg.use_kernel
    )
    sel_ids = ops.take_topk_ids(cand, sel_pos)
    return _merge_topk(chunk_nbrs, chunk_scores, sel_ids, sel_scores, k)


def _init_graph(n: int, k: int, generator: torch.Generator, device) -> torch.Tensor:
    """Random initial neighbors, self-loops remapped (same rule as repro;
    torch's draws differ from jax.random's)."""
    ids = torch.randint(0, n, (n, k), generator=generator, device=device, dtype=torch.int32)
    own = torch.arange(n, dtype=torch.int32, device=device)[:, None]
    return torch.where(ids == own, (ids + 1) % n, ids)


def build_knn_graph(
    corpus: FusedVectors,
    cfg: KnnConfig,
    generator: torch.Generator,
    *,
    queries: FusedVectors | None = None,
    init_ids: torch.Tensor | None = None,
    rounds: Sequence[torch.Tensor] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """NN-Descent over the fused corpus, host-driven (``repro``'s legacy
    path, the reference its pipeline is held against). Returns (nbr_ids
    (N, K), scores (N, K)) sorted by hybrid score, descending per row.

    queries: optional weight-scaled view of the corpus (Theorem 1), for the
        per-path refinement rounds.
    init_ids: optional (N, >= K) warm-start graph; narrower ones are widened
        with random ids.
    rounds: optional (N, extra_random) random-candidate tables, one per
        round, in place of the draws from ``generator`` (a test feeds in
        ``repro``'s).
    Every launch goes through the ``fused_topk`` wrapper."""
    n, k, dev = corpus.n, cfg.k, corpus.device
    queries = corpus if queries is None else queries
    if init_ids is None:
        nbr_ids = _init_graph(n, k, generator, dev)
    else:
        nbr_ids = init_ids[:, :k].to(device=dev, dtype=torch.int32)
        if nbr_ids.shape[1] < k:
            extra = _init_graph(n, k - nbr_ids.shape[1], generator, dev)
            nbr_ids = torch.cat([nbr_ids, extra], dim=1)
    node_ids = torch.arange(n, dtype=torch.int32, device=dev)
    dispatch.tick()
    # k == row width, so the fused top-k of the initial rows is their sort
    top, pos = ops.fused_topk_vs_ids(queries, corpus, nbr_ids.contiguous(), k,
                                     use_kernel=cfg.use_kernel)
    nbr_ids = ops.take_topk_ids(nbr_ids, pos)
    scores = torch.where(nbr_ids >= 0, top, torch.full_like(top, float("-inf")))
    for it in range(cfg.iters):
        if rounds is None:
            rand_ids = torch.randint(0, n, (n, cfg.extra_random), generator=generator,
                                     device=dev, dtype=torch.int32)
        else:
            rand_ids = torch.as_tensor(rounds[it]).to(device=dev, dtype=torch.int32)
        ids_out, sc_out = [], []
        for s in range(0, n, cfg.node_chunk):
            e = min(s + cfg.node_chunk, n)
            dispatch.tick()
            ids_c, sc_c = _descent_round_chunk(corpus, nbr_ids, queries[s:e], node_ids[s:e],
                                               nbr_ids[s:e], scores[s:e], rand_ids[s:e], cfg)
            ids_out.append(ids_c)
            sc_out.append(sc_c)
        nbr_ids, scores = torch.cat(ids_out), torch.cat(sc_out)
    return nbr_ids, scores


def knn_recall(nbr_ids, truth_ids) -> float:
    """Fraction of the true k-NN recovered (NN-Descent's quality)."""
    as_np = lambda a: a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
    nbr, truth = as_np(nbr_ids), as_np(truth_ids)
    hits = sum(len(set(a.tolist()) & set(b.tolist())) for a, b in zip(nbr, truth))
    return hits / truth.size


def reverse_neighbors(nbr_ids: torch.Tensor, cap: int) -> torch.Tensor:
    """Fixed-width reverse adjacency: rev[v] lists up to ``cap`` nodes u
    with v in N(u), in increasing u (id-sort + per-group position)."""
    n, k = nbr_ids.shape
    dev = nbr_ids.device
    dst = nbr_ids.reshape(-1).long()
    src = torch.arange(n, dtype=torch.int32, device=dev).repeat_interleave(k)
    dst_s = torch.where(dst >= 0, dst, torch.full_like(dst, n))  # invalid to the end
    dst_sorted, order = torch.sort(dst_s, stable=True)
    src_sorted = src[order]
    group_start = torch.searchsorted(dst_sorted, dst_sorted, side="left")
    pos = torch.arange(n * k, device=dev) - group_start
    keep = (dst_sorted < n) & (pos < cap)
    rev = torch.full((n, cap), PAD_IDX, dtype=torch.int32, device=dev)
    rev[dst_sorted[keep], pos[keep]] = src_sorted[keep]
    return rev


def new_node_reverse(merged_ids: torch.Tensor, n_old: int, cap: int) -> torch.Tensor:
    """Reverse adjacency among the NEW nodes of an insert batch.

    merged_ids: (n_new, K) candidate lists holding GLOBAL ids: old-corpus ids
    are < n_old, new-node ids >= n_old. Only new-node targets get rows in the
    returned (n_new, cap) table; old-corpus targets are dropped (the insert's
    back-link pass handles them). Returned source ids are GLOBAL (>= n_old).
    Feeding global ids straight into ``reverse_neighbors`` would treat
    old-corpus ids < n_new as new-node rows."""
    pad = torch.full_like(merged_ids, PAD_IDX)
    local = torch.where(merged_ids >= n_old, merged_ids - n_old, pad)
    rev = reverse_neighbors(local, cap)
    return torch.where(rev >= 0, rev + n_old, torch.full_like(rev, PAD_IDX))
