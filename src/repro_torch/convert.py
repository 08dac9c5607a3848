"""Carry ``repro``'s state into the port, from numpy arrays under ``repro``'s
field names. Imports no JAX: the caller does the ``np.asarray`` on the JAX
side.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.core.index import INDEX_FIELDS, HybridIndex
from repro_torch.core.usms import FusedVectors, SparseVec

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


def index_from_numpy(mapping: Mapping, device) -> HybridIndex:
    """HybridIndex from ``repro``'s leaves: ``mapping["corpus"]`` is a mapping
    with the ``fused_from_numpy`` argument names (dense, learned_idx, ...);
    every other ``HybridIndex`` field maps to its numpy array."""
    missing = [f for f in ("corpus",) + INDEX_FIELDS if f not in mapping]
    if missing:
        raise KeyError(f"index_from_numpy: missing fields {missing}")
    corpus = fused_from_numpy(device=device, **mapping["corpus"])

    def leaf(name):
        a = np.asarray(mapping[name])
        if name in _INT_FIELDS:
            a = a.astype(np.int32)
        elif name in ("alive", "entity_adj"):
            a = a.astype(bool)
        else:
            a = a.astype(np.float32)
        return torch.tensor(a, device=device)

    return HybridIndex(corpus=corpus, **{f: leaf(f) for f in INDEX_FIELDS})
