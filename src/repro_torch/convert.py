"""Carry ``repro``'s state into the port, from numpy arrays under ``repro``'s
field names: corpora (fp32 or int8 storage), indexes, segmented indexes,
segment pools, model parameters and train states (parameters and train
states back, too). Imports no JAX: every leaf goes through ``np.asarray``.
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
    """(name, parameter, path in ``repro``'s tree, layer index or None):
    block parameters ``layers.<i>.<rest>`` sit at ``("layers", *rest)[i]``
    in ``repro``'s layer-stacked tree."""
    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[0] == "layers":
            yield name, p, ("layers",) + tuple(parts[2:]), int(parts[1])
        else:
            yield name, p, tuple(parts), None


def _tree_paths(tree, prefix=()):
    for key, sub in tree.items():
        if isinstance(sub, Mapping):
            yield from _tree_paths(sub, prefix + (key,))
        else:
            yield prefix + (key,)


def _leaves_by_name(model: Transformer, tree: Mapping, what: str) -> dict:
    """{parameter name: float32 numpy array} from a tree with ``repro``'s
    parameter keys and layer-stacked leaves; shapes checked against the
    model's."""
    paths = list(_param_paths(model))
    extra = set(_tree_paths(tree)) - {path for _, _, path, _ in paths}
    if extra:
        raise KeyError(f"{what}: leaves the {model.cfg.family} model lacks: {sorted(extra)}")
    stacked: dict = {}
    out = {}
    for name, p, path, layer in paths:
        if path not in stacked:
            node = tree
            for key in path:
                node = node[key]
            stacked[path] = np.asarray(node, np.float32)
        a = stacked[path] if layer is None else stacked[path][layer]
        if tuple(a.shape) != tuple(p.shape):
            raise ValueError(f"{what}: {'.'.join(path)}: shape {a.shape}, the model wants "
                             f"{tuple(p.shape)}")
        out[name] = a
    return out


def model_params_from_numpy(cfg: ModelConfig, tree: Mapping, device) -> Transformer:
    """The port's parameters from ``repro``'s parameter tree (nested dicts,
    layer-stacked leaves (n_layers, ...), numpy or anything ``np.asarray``
    takes). bfloat16 leaves (``ml_dtypes.bfloat16``) go through float32, which
    holds every bfloat16 value exactly. ``device=None`` -> CUDA."""
    model = Transformer(cfg, resolve_device(device))
    leaves = _leaves_by_name(model, tree, "model_params_from_numpy")
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(torch.tensor(leaves[name]).to(p.dtype))
    return model


def _stacked_tree(model: Transformer, tensors: Mapping) -> dict:
    """``repro``'s tree of one tensor per parameter (``tensors`` keyed by
    parameter name): nested dicts, block leaves stacked over layers, dtypes
    and device kept."""
    tree: dict = {}
    stacks: dict = {}
    for name, _, path, layer in _param_paths(model):
        t = tensors[name].detach()
        if layer is None:
            node = tree
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = t
        else:
            stacks.setdefault(path, []).append(t)
    for path, ts in stacks.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = torch.stack(ts)
    return tree


def _map_tree(fn, tree):
    return {k: _map_tree(fn, v) if isinstance(v, Mapping) else fn(v) for k, v in tree.items()}


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.float().cpu().numpy()


def model_params_to_numpy(model: Transformer) -> dict:
    """``repro``'s parameter tree from the port's parameters: nested dicts,
    leaves stacked over layers, as float32 numpy arrays (exact for bfloat16;
    cast to ``model.cfg.dtype`` on the other side)."""
    return _map_tree(_to_numpy, _stacked_tree(model, dict(model.named_parameters())))


def train_state_to_tree(state: Mapping) -> dict:
    """``repro``'s train-state tree, ``{"opt": {"m", "step", "v"}, "params"}``,
    from the port's (``training.train_loop``): torch tensors in their own
    dtypes, parameters and moments under ``repro``'s parameter keys, stacked
    over layers."""
    model = state["params"]
    o = state["opt"]
    return {
        "opt": {"m": _stacked_tree(model, o["m"]), "step": o["step"].detach(),
                "v": _stacked_tree(model, o["v"])},
        "params": _stacked_tree(model, dict(model.named_parameters())),
    }


def train_state_to_numpy(state: Mapping) -> dict:
    """``train_state_to_tree`` as numpy: float32 leaves (exact for bfloat16;
    cast on the other side) and an int32 step."""
    tree = train_state_to_tree(state)
    out = _map_tree(_to_numpy, tree)
    out["opt"]["step"] = np.asarray(tree["opt"]["step"].cpu().numpy(), np.int32)
    return out


def train_state_from_numpy(cfg: ModelConfig, tree: Mapping, device,
                           moment_dtype: str = "float32") -> dict:
    """The port's train state from ``repro``'s (``{"params": ..., "opt":
    {"m", "v", "step"}}``, numpy leaves or anything ``np.asarray`` takes):
    parameters in ``cfg.dtype``, moments in ``moment_dtype``, the step int32;
    on ``device`` (``None`` -> CUDA)."""
    model = model_params_from_numpy(cfg, tree["params"], device)
    dev = model.device
    dt = torch.bfloat16 if moment_dtype == "bfloat16" else torch.float32
    opt_tree = tree["opt"]

    def moments(key):
        leaves = _leaves_by_name(model, opt_tree[key], f"train_state_from_numpy: opt.{key}")
        return {n: torch.tensor(a).to(device=dev, dtype=dt) for n, a in leaves.items()}

    step = torch.tensor(np.asarray(opt_tree["step"]).astype(np.int32), device=dev)
    return {"params": model, "opt": {"m": moments("m"), "v": moments("v"), "step": step}}
