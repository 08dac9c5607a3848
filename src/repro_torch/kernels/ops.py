"""Public hybrid-distance ops over the kernels. Port of ``repro/kernels/ops.py``.

``hybrid_scores``           — (B queries) x (B, C gathered rows) -> (B, C)
``hybrid_scores_vs_ids``    — score corpus rows by id, PAD ids -> -inf
``fused_topk`` / ``_vs_ids``— distance + top-k selection: (B, k) scores +
                              candidate positions, no (B, C) output
``pairwise_tile_scores``    — (C, K, K) candidate-pair tiles (RNG-IP pruning)
``pairwise_scores_chunked`` — brute-force (N x M) ground truth

Every op takes ``use_kernel``: ``None`` (the default) goes through the kernel
wrapper, which launches the CUDA kernel for CUDA tensors and takes the plain
version for CPU tensors; ``False`` asks for the plain PyTorch version on any
device (the chip check holds the kernels against it). The ``*_vs_ids`` forms
are the main path's: the kernels gather rows by id, so no gathered copy of
the candidates is built. The gathered forms view ``cands`` as a corpus of
B*C rows addressed by position. Candidates in int8 storage
(``QuantizedFusedVectors``) go to the ``has_scale`` variants, as
``repro/kernels/ops.py`` dispatches on the corpus type.
"""

from __future__ import annotations

import torch

from repro_torch.core.usms import PAD_IDX, FusedVectors, QuantizedFusedVectors, SparseVec
from repro_torch.kernels import ref
from repro_torch.kernels.fused_topk import NEG as NEG  # re-export
from repro_torch.kernels.fused_topk import (
    fused_topk_int8,
    fused_topk_int8_plain,
    fused_topk_plain,
)
from repro_torch.kernels.fused_topk import fused_topk as _fused_topk_kernel
from repro_torch.kernels.hybrid_distance import (
    hybrid_distance,
    hybrid_distance_int8,
    hybrid_distance_int8_plain,
    hybrid_distance_plain,
)
from repro_torch.kernels.pairwise_tile import pairwise_tile, pairwise_tile_plain


def _quantized(corpus) -> bool:
    return isinstance(corpus, QuantizedFusedVectors)


def _contig(f):
    c = lambda t: t.contiguous()
    sv = lambda v: SparseVec(c(v.idx), c(v.val))
    if _quantized(f):
        return QuantizedFusedVectors(c(f.dense_q), c(f.dense_scale), sv(f.learned), sv(f.lexical))
    return FusedVectors(c(f.dense), sv(f.learned), sv(f.lexical))


def _flat_rows(cands):
    """View (B, C, ...) gathered rows as a (B*C, ...) corpus plus the (B, C)
    position ids that address it."""
    lead = cands.dense_q if _quantized(cands) else cands.dense
    b, c = lead.shape[:2]
    flat = lambda t: t.reshape((b * c,) + tuple(t.shape[2:]))
    sv = lambda v: SparseVec(flat(v.idx), flat(v.val))
    if _quantized(cands):
        corpus = QuantizedFusedVectors(flat(cands.dense_q), flat(cands.dense_scale),
                                       sv(cands.learned), sv(cands.lexical))
    else:
        corpus = FusedVectors(flat(cands.dense), sv(cands.learned), sv(cands.lexical))
    pos = torch.arange(b * c, dtype=torch.int32, device=lead.device).reshape(b, c)
    return _contig(corpus), pos


def _distance_fns(corpus):
    """(kernel wrapper, plain version) of the distance op for a storage type."""
    if _quantized(corpus):
        return hybrid_distance_int8, hybrid_distance_int8_plain
    return hybrid_distance, hybrid_distance_plain


def _topk_fns(corpus):
    """(kernel wrapper, plain version) of the fused top-k op for a storage type."""
    if _quantized(corpus):
        return fused_topk_int8, fused_topk_int8_plain
    return _fused_topk_kernel, fused_topk_plain


def hybrid_scores(q: FusedVectors, cands, *, use_kernel: bool | None = None):
    """Score B queries against their (B, C, ...) candidate rows -> (B, C).
    Weights must already be folded into ``q`` (usms.weighted_query)."""
    if use_kernel is False:
        if _quantized(cands):
            return ref.hybrid_scores_quant_ref(q, cands)
        return ref.hybrid_scores_ref(q, cands)
    corpus, pos = _flat_rows(cands)
    return _distance_fns(corpus)[0](_contig(q), corpus, pos)


def hybrid_scores_vs_ids(
    q: FusedVectors,
    corpus,
    ids: torch.Tensor,  # (B, C) int32; PAD_IDX entries score -inf
    *,
    use_kernel: bool | None = None,
) -> torch.Tensor:
    ids = ids.to(torch.int32).contiguous()
    kernel, plain = _distance_fns(corpus)
    if use_kernel is False:
        return plain(q, corpus, ids)
    return kernel(_contig(q), corpus, ids)


def fused_topk(
    q: FusedVectors,
    cands,
    cid: torch.Tensor,  # (B, C) int32 candidate ids; PAD_IDX slots invalid
    k: int,
    *,
    bias: torch.Tensor | None = None,
    use_kernel: bool | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused distance + top-k over gathered rows: ``(scores, positions)``
    (B, k), descending, ties to the lowest position; invalid slots
    ``(NEG, PAD_IDX)``. ``bias`` must be finite (mask via PAD ids)."""
    bias = None if bias is None else bias.float().contiguous()
    if use_kernel is False:
        if _quantized(cands):
            return ref.fused_topk_quant_ref(q, cands, cid, bias, k)
        return ref.fused_topk_ref(q, cands, cid, bias, k)
    corpus, pos = _flat_rows(cands)
    ids = torch.where(cid >= 0, pos, torch.full_like(pos, PAD_IDX))
    return _topk_fns(corpus)[0](_contig(q), corpus, ids, k, bias)


def fused_topk_vs_ids(
    q: FusedVectors,
    corpus,
    ids: torch.Tensor,  # (B, C) int32 candidate ids into the corpus
    k: int,
    *,
    bias: torch.Tensor | None = None,
    use_kernel: bool | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused distance + top-k with the candidate rows addressed by id (the
    kernel gathers them itself)."""
    ids = ids.to(torch.int32).contiguous()
    bias = None if bias is None else bias.float().contiguous()
    kernel, plain = _topk_fns(corpus)
    if use_kernel is False:
        return plain(q, corpus, ids, k, bias)
    return kernel(_contig(q), corpus, ids, k, bias)


def take_topk(values: torch.Tensor, pos: torch.Tensor, fill) -> torch.Tensor:
    """Gather per-candidate values at fused-top-k positions (PAD -> fill)."""
    got = torch.gather(values, -1, pos.clamp(0, values.shape[-1] - 1).long())
    return torch.where(pos >= 0, got, torch.full_like(got, fill))


def take_topk_ids(ids: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Resolve fused-top-k positions back to candidate ids (PAD -> PAD_IDX)."""
    return take_topk(ids, pos, PAD_IDX)


def pairwise_tile_scores(tile: FusedVectors, *, use_kernel: bool | None = None) -> torch.Tensor:
    """All-pairs hybrid scores within each node's gathered (C, K, ...) tile."""
    if use_kernel is False:
        return ref.pairwise_tile_ref(tile)
    corpus, pos = _flat_rows(tile)
    return pairwise_tile(corpus, pos)


def pairwise_tile_scores_vs_ids(
    corpus: FusedVectors, cand_ids: torch.Tensor, *, use_kernel: bool | None = None
) -> torch.Tensor:
    """(C, K, K) pair scores among each node's candidates, rows addressed by
    id. PAD ids are gathered as row 0, as ``repro``'s ``corpus.take``; the
    caller masks invalid columns."""
    ids = cand_ids.clamp(0, corpus.n - 1).to(torch.int32).contiguous()
    if use_kernel is False:
        return pairwise_tile_plain(corpus, ids)
    return pairwise_tile(corpus, ids)


def _sparse_vs_rows(q: SparseVec, rows: SparseVec, vocab: int) -> torch.Tensor:
    """(Nq, P) x (M, Pc) ELL -> (Nq, M) sparse inner products through a
    dense (Nq, vocab) scatter of the queries (ids unique per row)."""
    qd = torch.zeros((q.idx.shape[0], vocab), dtype=torch.float32, device=q.idx.device)
    live = q.idx >= 0
    qd.scatter_add_(1, q.idx.clamp(min=0).long(), torch.where(live, q.val.float(), 0.0))
    hit = qd[:, rows.idx.clamp(min=0).long()]  # (Nq, M, Pc)
    return (hit * torch.where(rows.idx >= 0, rows.val.float(), 0.0)).sum(-1)


def _score_chunks(queries: FusedVectors, corpus: FusedVectors, chunk: int):
    """Yield (start, (Nq, m) brute-force scores) over corpus chunks. The
    dense part is ``torch.matmul``; the sparse parts gather from a dense
    scatter of the queries."""
    top = lambda t: int(t.max().item()) if t.numel() else 0
    vocab_s = max(top(queries.learned.idx), top(corpus.learned.idx), 0) + 1
    vocab_f = max(top(queries.lexical.idx), top(corpus.lexical.idx), 0) + 1
    for s in range(0, corpus.n, chunk):
        blk = corpus[s:s + chunk]
        dense = queries.dense.float() @ blk.dense.float().T
        sp = _sparse_vs_rows(queries.learned, blk.learned, vocab_s)
        fp = _sparse_vs_rows(queries.lexical, blk.lexical, vocab_f)
        yield s, dense + sp + fp


def pairwise_scores_chunked(
    queries: FusedVectors, corpus: FusedVectors, *, chunk: int = 4096
) -> torch.Tensor:
    """Brute-force (Nq, Ncorpus) hybrid scores, chunked over the corpus
    (ground truth and exact rerank; plain PyTorch)."""
    return torch.cat([sc for _, sc in _score_chunks(queries, corpus, chunk)], dim=1)


def topk_hybrid(
    queries: FusedVectors, corpus: FusedVectors, k: int, *, chunk: int = 4096
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k by brute force (ground truth), merged chunk by chunk so
    the (Nq, Ncorpus) matrix never exists. Ties go to the lowest id.
    Returns (scores, ids)."""
    best_s = best_i = None
    for s, sc in _score_chunks(queries, corpus, chunk):
        t, p = ref.topk_desc(sc, min(k, sc.shape[1]))
        p = p + s
        if best_s is not None:  # earlier chunks first: ties keep the lower id
            t, order = ref.topk_desc(torch.cat([best_s, t], dim=1), k)
            p = torch.gather(torch.cat([best_i, p], dim=1), 1, order)
        best_s, best_i = t, p
    return best_s, best_i.to(torch.int32)
