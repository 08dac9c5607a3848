"""Plain PyTorch versions of the hybrid distance kernels.

Port of ``repro/kernels/ref.py``. These are the plain versions each CUDA
kernel is held against; the kernel wrappers take them for CPU tensors only.

Semantics contract (shared with the CUDA kernels):

  score(q, c) = <q.dense, c.dense> + sp_ip(q.learned, c.learned)
                                   + sp_ip(q.lexical, c.lexical)

where ``sp_ip`` is the sparse inner product over fixed-nnz ELL vectors and
padded slots (idx == PAD_IDX) never match. Path weights are folded into the
query beforehand (``usms.weighted_query``), so the kernels are weight-free.
"""

from __future__ import annotations

import torch

from repro_torch.core.usms import PAD_IDX, FusedVectors, QuantizedFusedVectors

NEG = -1e30  # "no candidate" score sentinel of the fused top-k path


def sparse_ip_ref(
    q_idx: torch.Tensor, q_val: torch.Tensor, c_idx: torch.Tensor, c_val: torch.Tensor
) -> torch.Tensor:
    """Sparse inner product via all-pairs index matching.

    q_idx/q_val: (B, Pq); c_idx/c_val: (B, C, Pc) -> (B, C) float32.
    """
    qi = q_idx[:, None, None, :]  # (B, 1, 1, Pq)
    ci = c_idx[..., :, None]  # (B, C, Pc, 1)
    match = (ci == qi) & (ci >= 0) & (qi >= 0)
    # ids are unique per row, so each candidate slot matches at most one
    # query slot: reduce over the query axis first, then weight by c_val
    q_hit = torch.where(match, q_val[:, None, None, :].float(), 0.0).sum(-1)
    return (q_hit * c_val.float()).sum(-1)


def hybrid_scores_ref(q: FusedVectors, cands: FusedVectors) -> torch.Tensor:
    """q: batch of B queries; cands: (B, C, ...) candidate rows -> (B, C)."""
    dense = torch.einsum("bd,bcd->bc", q.dense.float(), cands.dense.float())
    sp = sparse_ip_ref(q.learned.idx, q.learned.val, cands.learned.idx, cands.learned.val)
    fp = sparse_ip_ref(q.lexical.idx, q.lexical.val, cands.lexical.idx, cands.lexical.val)
    return dense + sp + fp


def hybrid_scores_quant_ref(q: FusedVectors, cands: QuantizedFusedVectors) -> torch.Tensor:
    """Quantized-storage oracle: ``scale_c * <q, int8_c>``. The scale
    multiplies the dense dot product, not the rows (DESIGN.md §13), as the
    int8 kernel does after its warp reduction."""
    dense = torch.einsum(
        "bd,bcd->bc", q.dense.float(), cands.dense_q.float()
    ) * cands.dense_scale.float()
    sp = sparse_ip_ref(q.learned.idx, q.learned.val, cands.learned.idx, cands.learned.val)
    fp = sparse_ip_ref(q.lexical.idx, q.lexical.val, cands.lexical.idx, cands.lexical.val)
    return dense + sp + fp


def fused_topk_ref(
    q: FusedVectors,
    cands: FusedVectors,
    cid: torch.Tensor,  # (B, C) int32 candidate ids; PAD_IDX slots are invalid
    bias: torch.Tensor | None,  # (B, C) f32 pre-selection score bias, or None
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain fused distance + top-k: ``(scores, positions)`` of shape (B, k),
    descending, ties to the lowest position; invalid slots (NEG, PAD_IDX)."""
    return select_topk_ref(hybrid_scores_ref(q, cands), cid, bias, k)


def fused_topk_quant_ref(
    q: FusedVectors,
    cands: QuantizedFusedVectors,
    cid: torch.Tensor,
    bias: torch.Tensor | None,
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``fused_topk_ref`` over quantized candidate storage (same contract)."""
    return select_topk_ref(hybrid_scores_quant_ref(q, cands), cid, bias, k)


def topk_desc(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` semantics along the last axis: descending values, ties
    to the lowest index. ``torch.topk`` does not promise that tie order, so
    this is a stable descending sort cut to k."""
    vals, pos = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], pos[..., :k]


def select_topk_ref(
    scores: torch.Tensor, cid: torch.Tensor, bias: torch.Tensor | None, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    if bias is not None:
        scores = scores + bias.float()
    scores = torch.where(cid >= 0, scores, torch.full_like(scores, NEG))
    b, c = scores.shape
    k_eff = min(k, c)
    top, pos = topk_desc(scores, k_eff)
    pos = pos.to(torch.int32)
    if k_eff < k:
        top = torch.cat([top, top.new_full((b, k - k_eff), NEG)], dim=1)
        pos = torch.cat([pos, pos.new_full((b, k - k_eff), PAD_IDX)], dim=1)
    pos = torch.where(top > NEG, pos, torch.full_like(pos, PAD_IDX))
    return top, pos


def _pair_sparse(ai, av, bi, bv) -> torch.Tensor:
    """(..., A, P) x (..., B, Q) ELL rows -> (..., A, B) sparse inner products;
    ``ai >= 0`` gates the match (a PAD slot can only equal a PAD slot)."""
    m = (ai[..., :, None, :, None] == bi[..., None, :, None, :]) & (
        ai[..., :, None, :, None] >= 0
    )
    hit = torch.where(m, bv[..., None, :, None, :].float(), 0.0).sum(-1)  # (..., A, B, P)
    return (hit * av[..., :, None, :].float()).sum(-1)


def pairwise_tile_ref(tile: FusedVectors) -> torch.Tensor:
    """All-pairs hybrid scores within each candidate tile: tile (C, K, ...)
    -> (C, K, K) with out[c, i, j] = score(tile[c, i], tile[c, j]). No
    per-id validity masking here."""
    d = tile.dense.float()
    dense = torch.einsum("cid,cjd->cij", d, d)
    sp = _pair_sparse(tile.learned.idx, tile.learned.val, tile.learned.idx, tile.learned.val)
    fp = _pair_sparse(tile.lexical.idx, tile.lexical.val, tile.lexical.idx, tile.lexical.val)
    return dense + sp + fp


def pairwise_hybrid_scores_ref(a: FusedVectors, b: FusedVectors) -> torch.Tensor:
    """All-pairs scores between two flat sets: a (N, ...) x b (M, ...) -> (N, M).
    Brute-force oracle for ground truth in recall checks."""
    dense = a.dense.float() @ b.dense.float().T

    def sp_all(aidx, aval, bidx, bval):
        m = (
            (aidx[:, None, :, None] == bidx[None, :, None, :])
            & (aidx[:, None, :, None] >= 0)
            & (bidx[None, :, None, :] >= 0)
        )
        hit = torch.where(m, bval[None, :, None, :].float(), 0.0).sum(-1)  # (N, M, Pa)
        return (hit * aval[:, None, :].float()).sum(-1)

    sp = sp_all(a.learned.idx, a.learned.val, b.learned.idx, b.learned.val)
    fp = sp_all(a.lexical.idx, a.lexical.val, b.lexical.idx, b.lexical.val)
    return dense + sp + fp
