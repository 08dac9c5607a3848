"""Carry ``repro``'s state into the port, from numpy arrays under ``repro``'s
field names: corpora (fp32 or int8 storage), indexes, segmented indexes and
segment pools. Imports no JAX: every leaf goes through ``np.asarray``.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.core.distributed import SegmentedIndex
from repro_torch.core.index import INDEX_FIELDS, HybridIndex
from repro_torch.core.segment_pool import SegmentPool
from repro_torch.core.usms import FusedVectors, QuantizedFusedVectors, SparseVec

_INT_FIELDS = {
    "semantic_edges", "keyword_edges", "logical_edges", "doc_entities",
    "entity_to_docs", "entry_points",
}


def fused_from_numpy(dense, learned_idx, learned_val, lexical_idx, lexical_val,
                     device) -> FusedVectors:
    """FusedVectors (float32 values, int32 ids) on ``device``."""
    f = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    i = lambda a: torch.tensor(np.asarray(a, np.int32), device=device)
    return FusedVectors(
        f(dense), SparseVec(i(learned_idx), f(learned_val)),
        SparseVec(i(lexical_idx), f(lexical_val)),
    )


def _leaf(name: str, a, device) -> torch.Tensor:
    """One non-corpus ``HybridIndex`` field: int32 ids, bool masks, float32
    scores."""
    a = np.asarray(a)
    if name in _INT_FIELDS:
        a = a.astype(np.int32)
    elif name in ("alive", "entity_adj"):
        a = a.astype(bool)
    else:
        a = a.astype(np.float32)
    return torch.tensor(a, device=device)


def index_from_numpy(mapping: Mapping, device) -> HybridIndex:
    """HybridIndex from ``repro``'s leaves: ``mapping["corpus"]`` is a mapping
    with the ``fused_from_numpy`` argument names (dense, learned_idx, ...);
    every other ``HybridIndex`` field maps to its numpy array."""
    missing = [f for f in ("corpus",) + INDEX_FIELDS if f not in mapping]
    if missing:
        raise KeyError(f"index_from_numpy: missing fields {missing}")
    corpus = fused_from_numpy(device=device, **mapping["corpus"])
    return HybridIndex(corpus=corpus, **{f: _leaf(f, mapping[f], device) for f in INDEX_FIELDS})


def quantized_from_numpy(dense_q, dense_scale, learned_idx, learned_val, lexical_idx,
                         lexical_val, device) -> QuantizedFusedVectors:
    """QuantizedFusedVectors (int8 dense, float32 scale, int32 ids, float16
    values) on ``device``; the stored dtypes are kept, never widened."""
    as_ = lambda a, dt: torch.tensor(np.asarray(a).astype(dt, copy=False), device=device)
    return QuantizedFusedVectors(
        as_(dense_q, np.int8), as_(dense_scale, np.float32),
        SparseVec(as_(learned_idx, np.int32), as_(learned_val, np.float16)),
        SparseVec(as_(lexical_idx, np.int32), as_(lexical_val, np.float16)),
    )


def corpus_from_arrays(c, device):
    """A corpus from any object with ``repro``'s corpus field names (numpy
    or anything ``np.asarray`` takes): ``dense_q``/``dense_scale`` make a
    QuantizedFusedVectors, ``dense`` a FusedVectors."""
    sparse = dict(learned_idx=c.learned.idx, learned_val=c.learned.val,
                  lexical_idx=c.lexical.idx, lexical_val=c.lexical.val)
    if hasattr(c, "dense_q"):
        return quantized_from_numpy(c.dense_q, c.dense_scale, device=device, **sparse)
    return fused_from_numpy(c.dense, device=device, **sparse)


def index_from_arrays(index, device) -> HybridIndex:
    """HybridIndex from any object with ``repro``'s ``HybridIndex`` field
    names; its corpus may be quantized. Leaves may carry a leading segment
    axis."""
    return HybridIndex(corpus=corpus_from_arrays(index.corpus, device),
                       **{f: _leaf(f, getattr(index, f), device) for f in INDEX_FIELDS})


def segmented_from_arrays(seg, device) -> SegmentedIndex:
    """SegmentedIndex from an object with ``index`` and ``global_ids``."""
    return SegmentedIndex(
        index_from_arrays(seg.index, device),
        torch.tensor(np.asarray(seg.global_ids, np.int32), device=device),
    )


def pool_from_arrays(pool, device) -> SegmentPool:
    """SegmentPool from an object with ``groups`` of segmented indexes."""
    return SegmentPool(groups=[segmented_from_arrays(g, device) for g in pool.groups])
