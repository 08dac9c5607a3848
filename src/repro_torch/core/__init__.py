"""Allan-Poe core in PyTorch: the all-in-one hybrid graph index.

Exports ``repro.core``'s public names. They load on first use (PEP 562),
because the kernel modules import ``repro_torch.core.usms`` and importing
``build_pipeline`` here would make that a cycle. ``search`` names the
function, as in ``repro.core``, though the import system binds the
submodule of that name here once it loads.
"""

from __future__ import annotations

import importlib
import sys
import types

_WHERE = {
    "build_pipeline": ("build_graph", "build_index", "insert", "nn_descent"),
    "fusion": ("FUSION_MODES", "MINMAX", "RRF", "WEIGHTED_SUM", "ZSCORE", "FusionSpec",
               "PathStats", "adaptive_fusion", "as_fusion_spec", "stack_specs"),
    "index": ("BuildConfig", "HybridIndex", "mark_deleted"),
    "knn_graph": ("KnnConfig", "build_knn_graph"),
    "pruning": ("PruneConfig", "rng_ip_prune"),
    "search": ("SearchParams", "SearchResult", "search", "search_padded"),
    "usms": ("PAD_IDX", "FusedVectors", "PathWeights", "SparseVec", "stack_weights",
             "weighted_query"),
}
_MODULE_OF = {name: mod for mod, names in _WHERE.items() for name in names}

__all__ = [
    "BuildConfig",
    "HybridIndex",
    "FUSION_MODES",
    "WEIGHTED_SUM",
    "MINMAX",
    "ZSCORE",
    "RRF",
    "FusionSpec",
    "PathStats",
    "adaptive_fusion",
    "as_fusion_spec",
    "stack_specs",
    "build_graph",
    "build_index",
    "nn_descent",
    "insert",
    "mark_deleted",
    "KnnConfig",
    "build_knn_graph",
    "PruneConfig",
    "rng_ip_prune",
    "SearchParams",
    "SearchResult",
    "search",
    "search_padded",
    "PAD_IDX",
    "FusedVectors",
    "PathWeights",
    "SparseVec",
    "stack_weights",
    "weighted_query",
]


class _Core(types.ModuleType):
    @property
    def search(self):
        return importlib.import_module(f"{__name__}.search").search

    @search.setter
    def search(self, _submodule):
        pass  # the import system binding the submodule: the name keeps the function


sys.modules[__name__].__class__ = _Core


def __getattr__(name: str):
    if name not in _MODULE_OF:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{_MODULE_OF[name]}"), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
