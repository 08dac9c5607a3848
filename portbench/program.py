"""Adapters between the benchmark's inputs and the program under test.

The only module of the harness besides the traffic kinds that imports the
port (``repro_torch``): it hands the benchmark's rows to the program in the
program's types, builds its fusion specs from a cell's spec table, and reads
what the program built back out (leaves, bytes, ids). It never imports the
JAX package.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from portbench import work
from portbench.corpus import Rows


def fused(rows: Rows):
    """The benchmark's rows as the program's ``FusedVectors`` (no copy)."""
    from repro_torch.core.usms import FusedVectors, SparseVec

    return FusedVectors(rows.dense, SparseVec(rows.learned_idx, rows.learned_val),
                        SparseVec(rows.lexical_idx, rows.lexical_val))


def fusion_spec(spec: dict):
    """A cell's spec entry (``mode``, ``weights`` [dense, sparse, full],
    optional ``rrf_k``) as the program's ``FusionSpec``; zscore stats are left
    for the service to resolve."""
    from repro_torch.core.fusion import DEFAULT_RRF_K, FusionSpec

    wd, ws, wf = spec["weights"]
    return FusionSpec.make(spec["mode"], wd, ws, wf, rrf_k=float(spec.get("rrf_k", DEFAULT_RRF_K)))


def index_bytes(tensors) -> int:
    """Bytes of the distinct device storages behind ``tensors``."""
    seen, total = set(), 0
    for t in tensors:
        st = t.untyped_storage()
        key = (st.data_ptr(), st.nbytes())
        if key not in seen:
            seen.add(key)
            total += st.nbytes()
    return total


def hybrid_index_tensors(index) -> list:
    from repro_torch.core.index import INDEX_FIELDS

    return list(index.corpus.tensors()) + [getattr(index, f) for f in INDEX_FIELDS]


def segment_leaves(seg) -> dict:
    """One sealed single-segment index's leaves, by the reference's names."""
    idx = seg.index
    c = idx.corpus
    one = lambda t: t[0]
    return dict(dense_q=one(c.dense_q), dense_scale=one(c.dense_scale),
                learned_idx=one(c.learned.idx), learned_val=one(c.learned.val),
                lexical_idx=one(c.lexical.idx), lexical_val=one(c.lexical.val),
                semantic_edges=one(idx.semantic_edges), keyword_edges=one(idx.keyword_edges),
                entry_points=one(idx.entry_points), self_ip=one(idx.self_ip),
                alive=one(idx.alive), global_ids=one(seg.global_ids).cpu().numpy())


@contextlib.contextmanager
def kept_topk():
    """Keep every ``ops.fused_topk_vs_ids`` call made inside the body, as
    (ids, k, bias, scores, positions): the program's own tensors, held by
    reference, with no work added on the card."""
    from repro_torch.kernels import ops

    orig = ops.fused_topk_vs_ids
    kept: list = []

    def keep(q, corpus, ids, k, *, bias=None, **kw):
        scores, pos = orig(q, corpus, ids, k, bias=bias, **kw)
        kept.append((ids, int(k), bias, scores, pos))
        return scores, pos

    ops.fused_topk_vs_ids = keep
    try:
        yield kept
    finally:
        ops.fused_topk_vs_ids = orig


def host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def scoring_work(kind: str):
    """The work of a caught ``ops`` scoring call (fused top-k or distance by
    id) from its arguments' shapes and ids: (bytes, flops, peak, kernel)."""
    def count(q, corpus, ids, *rest, **kw):
        int8 = hasattr(corpus, "dense_q")
        dd = (corpus.dense_q if int8 else corpus.dense).shape[1]
        slots = corpus.learned.idx.shape[1] + corpus.lexical.idx.shape[1]
        q_slots = q.learned.idx.shape[1] + q.lexical.idx.shape[1]
        if kind == "fused_topk":
            out = ids.shape[0] * int(rest[0] if rest else kw["k"]) * 8  # scores + positions
        else:
            out = ids.numel() * 4
        nb, fl = work.scoring_work(q.n, work.row_bytes(dd, q_slots, False),
                                   work.row_bytes(dd, slots, int8), dd, ids, out)
        return nb, fl, work.FP32_FLOP_PER_S, kind
    return count


def tile_work(corpus, cand_ids, **kw):
    """The work of a caught pair-tile call (fp32 rows, 3xTF32 Gram)."""
    dd = corpus.dense.shape[1]
    slots = corpus.learned.idx.shape[1] + corpus.lexical.idx.shape[1]
    nb, fl = work.tile_work(work.row_bytes(dd, slots, False), dd, cand_ids)
    return nb, fl, work.TF32_FLOP_PER_S, "pairwise_tile"
