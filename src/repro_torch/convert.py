"""Carry ``repro``'s state into the port, from numpy arrays under ``repro``'s
field names: corpora (fp32 or int8 storage), indexes, segmented indexes,
segment pools and model parameters (and model parameters back). Imports no
JAX: every leaf goes through ``np.asarray``.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.core.distributed import SegmentedIndex
from repro_torch.core.index import INDEX_FIELDS, HybridIndex
from repro_torch.core.segment_pool import SegmentPool
from repro_torch.core.usms import FusedVectors, QuantizedFusedVectors, SparseVec
from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Transformer

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


def _param_paths(model: Transformer):
    """(parameter, path in ``repro``'s tree, layer index or None): block
    parameters ``layers.<i>.<rest>`` sit at ``("layers", *rest)[i]`` in
    ``repro``'s layer-stacked tree."""
    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[0] == "layers":
            yield p, ("layers",) + tuple(parts[2:]), int(parts[1])
        else:
            yield p, tuple(parts), None


def _tree_paths(tree, prefix=()):
    for key, sub in tree.items():
        if isinstance(sub, Mapping):
            yield from _tree_paths(sub, prefix + (key,))
        else:
            yield prefix + (key,)


def model_params_from_numpy(cfg: ModelConfig, tree: Mapping, device) -> Transformer:
    """The port's parameters from ``repro``'s parameter tree (nested dicts,
    layer-stacked leaves (n_layers, ...), numpy or anything ``np.asarray``
    takes). bfloat16 leaves (``ml_dtypes.bfloat16``) go through float32, which
    holds every bfloat16 value exactly. ``device=None`` -> CUDA."""
    model = Transformer(cfg, resolve_device(device))
    paths = list(_param_paths(model))
    want = {path for _, path, _ in paths}
    extra = set(_tree_paths(tree)) - want
    if extra:
        raise KeyError(f"model_params_from_numpy: leaves the {cfg.family} model lacks: "
                       f"{sorted(extra)}")
    leaves: dict = {}
    with torch.no_grad():
        for p, path, layer in paths:
            if path not in leaves:
                node = tree
                for key in path:
                    node = node[key]
                leaves[path] = np.asarray(node, np.float32)
            a = leaves[path] if layer is None else leaves[path][layer]
            if tuple(a.shape) != tuple(p.shape):
                raise ValueError(f"{'.'.join(path)}: shape {a.shape}, the model wants "
                                 f"{tuple(p.shape)}")
            p.copy_(torch.tensor(a).to(p.dtype))
    return model


def model_params_to_numpy(model: Transformer) -> dict:
    """``repro``'s parameter tree from the port's parameters: nested dicts,
    leaves stacked over layers, as float32 numpy arrays (exact for bfloat16;
    cast to ``model.cfg.dtype`` on the other side)."""
    tree: dict = {}
    stacks: dict = {}
    for p, path, layer in _param_paths(model):
        a = p.detach().float().cpu().numpy()
        if layer is None:
            node = tree
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = a
        else:
            stacks.setdefault(path, []).append(a)
    for path, arrays in stacks.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.stack(arrays)
    return tree
