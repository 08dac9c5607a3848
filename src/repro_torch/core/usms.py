"""Unified Semantic Metric Space (USMS), paper §3.1/§3.2.

Port of ``repro/core/usms.py``. Weighted hybrid search is exactly Maximum
Inner Product Search (Theorem 1):

    M_w(q, d) = <[w_d·qd, w_s·qs, w_f·qf], [dd, ds, df]>

so weights are applied to the query only. Sparse vectors keep the fixed-nnz
ELL layout ``(idx, val)`` with ``PAD_IDX`` padding: ``idx == PAD_IDX`` ⇔
``val == 0``, indices unique per row. Sealed corpora may be held in
compressed storage (``QuantizedFusedVectors``: int8 dense + fp32 row scale,
fp16 sparse values).
"""

from __future__ import annotations

import dataclasses

import torch

PAD_IDX = -1  # sentinel for unused sparse slots / entity slots


@dataclasses.dataclass
class SparseVec:
    """Fixed-nnz (ELL) sparse vectors: idx (..., P) int32 PAD-padded,
    val (..., P) float32, 0 in padded slots."""

    idx: torch.Tensor
    val: torch.Tensor

    def __getitem__(self, key) -> "SparseVec":
        return SparseVec(self.idx[key], self.val[key])

    def to(self, device) -> "SparseVec":
        return SparseVec(self.idx.to(device), self.val.to(device))


@dataclasses.dataclass
class FusedVectors:
    """A batch of documents or queries in the USMS.

    dense:   (..., Dd) float32 semantic embedding.
    learned: SparseVec (..., Ps) learned sparse.
    lexical: SparseVec (..., Pf) full-text term weights; ``lexical.idx``
             doubles as the keyword set K(·) used by keyword edges.
    """

    dense: torch.Tensor
    learned: SparseVec
    lexical: SparseVec

    @property
    def n(self) -> int:
        return self.dense.shape[0]

    @property
    def device(self) -> torch.device:
        return self.dense.device

    def __getitem__(self, key) -> "FusedVectors":
        return FusedVectors(self.dense[key], self.learned[key], self.lexical[key])

    def to(self, device) -> "FusedVectors":
        return FusedVectors(
            self.dense.to(device), self.learned.to(device), self.lexical.to(device)
        )

    def take(self, ids: torch.Tensor) -> "FusedVectors":
        """Gather rows by id along axis 0 (any id shape). PAD ids are clipped
        to row 0, as ``repro``'s ``take`` does; callers mask the scores.
        Used only by the plain versions: the kernels gather by id inside."""
        safe = ids.clamp(0, self.n - 1).long()
        return FusedVectors(
            self.dense[safe],
            SparseVec(self.learned.idx[safe], self.learned.val[safe]),
            SparseVec(self.lexical.idx[safe], self.lexical.val[safe]),
        )

    def tensors(self) -> tuple[torch.Tensor, ...]:
        return (
            self.dense,
            self.learned.idx,
            self.learned.val,
            self.lexical.idx,
            self.lexical.val,
        )


@dataclasses.dataclass
class QuantizedFusedVectors:
    """A sealed corpus in compressed storage (DESIGN.md §13): per-row
    symmetric int8 dense vectors with fp32 scales, fp16 ELL sparse values
    (ids stay int32).

    dense_q:     (..., Dd) int8 — round(dense / scale), clipped to ±127.
    dense_scale: (...,) float32 — per-row scale; 1.0 for all-zero rows.
    learned:     SparseVec (..., Ps) with float16 vals.
    lexical:     SparseVec (..., Pf) with float16 vals.

    Has no ``.dense``, as in ``repro``: fp32 rows come back only through an
    explicit ``dequantize_corpus``.
    """

    dense_q: torch.Tensor
    dense_scale: torch.Tensor
    learned: SparseVec
    lexical: SparseVec

    @property
    def n(self) -> int:
        return self.dense_q.shape[0]

    @property
    def device(self) -> torch.device:
        return self.dense_q.device

    def __getitem__(self, key) -> "QuantizedFusedVectors":
        return QuantizedFusedVectors(
            self.dense_q[key], self.dense_scale[key], self.learned[key], self.lexical[key]
        )

    def to(self, device) -> "QuantizedFusedVectors":
        return QuantizedFusedVectors(
            self.dense_q.to(device), self.dense_scale.to(device),
            self.learned.to(device), self.lexical.to(device),
        )

    def take(self, ids: torch.Tensor) -> "QuantizedFusedVectors":
        """Gather rows by id along axis 0; PAD ids clip to row 0 (callers mask
        the scores). Used only by the plain versions."""
        safe = ids.clamp(0, self.n - 1).long()
        return QuantizedFusedVectors(
            self.dense_q[safe],
            self.dense_scale[safe],
            SparseVec(self.learned.idx[safe], self.learned.val[safe]),
            SparseVec(self.lexical.idx[safe], self.lexical.val[safe]),
        )

    def tensors(self) -> tuple[torch.Tensor, ...]:
        return (
            self.dense_q,
            self.dense_scale,
            self.learned.idx,
            self.learned.val,
            self.lexical.idx,
            self.lexical.val,
        )


def quantize_corpus(f: FusedVectors) -> QuantizedFusedVectors:
    """Seal-time compression of a built corpus: symmetric per-row int8 dense
    (scale = max|row| / 127, 1.0 for all-zero rows; ``torch.round`` rounds
    half to even like ``jnp.round``), fp16 sparse values (PAD slots stay 0)."""
    amax = f.dense.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax)).to(torch.float32)
    dense_q = torch.clamp(torch.round(f.dense / scale[..., None]), -127, 127).to(torch.int8)
    return QuantizedFusedVectors(
        dense_q,
        scale,
        SparseVec(f.learned.idx, f.learned.val.to(torch.float16)),
        SparseVec(f.lexical.idx, f.lexical.val.to(torch.float16)),
    )


def cat_fused(parts) -> FusedVectors:
    """Row-wise concatenation of fp32 corpora (new tensors: the parts are
    never written)."""
    cols = [torch.cat([p.tensors()[j] for p in parts]) for j in range(5)]
    return FusedVectors(cols[0], SparseVec(cols[1], cols[2]), SparseVec(cols[3], cols[4]))


def dequantize_corpus(q: QuantizedFusedVectors) -> FusedVectors:
    """fp32 storage back from a quantized corpus (rebuild / compaction input)."""
    return FusedVectors(
        q.dense_q.to(torch.float32) * q.dense_scale[..., None],
        SparseVec(q.learned.idx, q.learned.val.to(torch.float32)),
        SparseVec(q.lexical.idx, q.lexical.val.to(torch.float32)),
    )


def corpus_nbytes_by_leaf(corpus) -> dict:
    """Byte footprint of a corpus, keyed by (leaf, dtype) — feeds the
    ``allanpoe_index_bytes_total`` gauges."""
    out: dict = {}
    if isinstance(corpus, QuantizedFusedVectors):
        named = [("dense", corpus.dense_q), ("dense_scale", corpus.dense_scale)]
    else:
        named = [("dense", corpus.dense)]
    named += [
        ("sparse_idx", corpus.learned.idx),
        ("sparse_val", corpus.learned.val),
        ("sparse_idx", corpus.lexical.idx),
        ("sparse_val", corpus.lexical.val),
    ]
    for leaf, arr in named:
        key = (leaf, dtype_name(arr))
        out[key] = out.get(key, 0) + arr.numel() * arr.element_size()
    return out


def dtype_name(t: torch.Tensor) -> str:
    """numpy-style dtype name of a tensor ("float32", "int8", "bool")."""
    return str(t.dtype).replace("torch.", "")


@dataclasses.dataclass
class PathWeights:
    """Runtime fusion weights [w_d, w_s, w_f, w_k]: floats, 0-d tensors or
    (B,) tensors (per-query weights)."""

    dense: object
    sparse: object
    full: object
    kg: object

    @classmethod
    def make(cls, dense=1.0, sparse=0.0, full=0.0, kg=0.0) -> "PathWeights":
        f = lambda x: torch.as_tensor(x, dtype=torch.float32)
        return cls(f(dense), f(sparse), f(full), f(kg))

    @classmethod
    def three_path(cls) -> "PathWeights":
        return cls.make(1.0, 1.0, 1.0, 0.0)


def stack_weights(ws) -> PathWeights:
    """Stack per-request PathWeights into one whose leaves are (B,) tensors."""
    st = lambda xs: torch.stack([torch.as_tensor(x, dtype=torch.float32) for x in xs])
    return PathWeights(
        st([w.dense for w in ws]),
        st([w.sparse for w in ws]),
        st([w.full for w in ws]),
        st([w.kg for w in ws]),
    )


def _expand_weight(w, like: torch.Tensor) -> torch.Tensor:
    """A scalar or (B,) weight, right-padded with singleton axes so it
    broadcasts against (..., D)-shaped ``like``."""
    w = torch.as_tensor(w, dtype=torch.float32, device=like.device)
    return w.reshape(tuple(w.shape) + (1,) * (like.dim() - w.dim()))


def weighted_query(q: FusedVectors, w: PathWeights) -> FusedVectors:
    """Theorem 1: scale the query components by the path weights."""
    return FusedVectors(
        q.dense * _expand_weight(w.dense, q.dense),
        SparseVec(q.learned.idx, q.learned.val * _expand_weight(w.sparse, q.learned.val)),
        SparseVec(q.lexical.idx, q.lexical.val * _expand_weight(w.full, q.lexical.val)),
    )


def sparse_from_dense(x: torch.Tensor, nnz_cap: int) -> SparseVec:
    """Keep the top-``nnz_cap`` entries by magnitude (SEISMIC-style static
    pruning), ties to the lowest index as ``lax.top_k``: (..., V) dense ->
    SparseVec (..., nnz_cap); zero entries become PAD slots."""
    mag, idx = torch.sort(torch.abs(x), dim=-1, descending=True, stable=True)
    mag, idx = mag[..., :nnz_cap], idx[..., :nnz_cap]
    keep = mag > 0
    return SparseVec(torch.where(keep, idx, torch.full_like(idx, PAD_IDX)).to(torch.int32),
                     torch.where(keep, torch.gather(x, -1, idx), torch.zeros_like(mag)))


def sparse_to_dense(s: SparseVec, vocab: int) -> torch.Tensor:
    """Scatter an ELL sparse vector back to dense, duplicates summed
    (oracle / testing only): (..., P) -> (..., vocab)."""
    idx = s.idx.reshape(-1, s.idx.shape[-1]).long()
    val = s.val.reshape(-1, s.val.shape[-1])
    live = idx >= 0
    out = torch.zeros((idx.shape[0], vocab), dtype=val.dtype, device=val.device)
    out.scatter_add_(1, torch.where(live, idx, torch.zeros_like(idx)),
                     torch.where(live, val, torch.zeros_like(val)))
    return out.reshape(tuple(s.idx.shape[:-1]) + (vocab,))


def concat_dense(f: FusedVectors, vocab_s: int, vocab_f: int) -> torch.Tensor:
    """f_concat(d) = [dense, sparse, full] as one dense vector (oracle /
    testing only, never at scale)."""
    return torch.cat([f.dense, sparse_to_dense(f.learned, vocab_s),
                      sparse_to_dense(f.lexical, vocab_f)], dim=-1)


def keyword_overlap(a_idx: torch.Tensor, b_idx: torch.Tensor) -> torch.Tensor:
    """|K(a) ∩ K(b)| for PAD-padded keyword id arrays: (..., Pa) x (..., Pb)
    -> (...,) int32. Assumes unique ids per row."""
    eq = a_idx.unsqueeze(-1) == b_idx.unsqueeze(-2)
    valid = (a_idx.unsqueeze(-1) >= 0) & (b_idx.unsqueeze(-2) >= 0)
    return (eq & valid).sum(dim=(-1, -2)).to(torch.int32)


def has_keyword_overlap(a_idx: torch.Tensor, b_idx: torch.Tensor) -> torch.Tensor:
    return keyword_overlap(a_idx, b_idx) > 0
