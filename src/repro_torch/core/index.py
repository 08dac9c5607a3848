"""The all-in-one hybrid index structure (paper §3, §4.1).
Port of ``repro/core/index.py``: a dataclass of tensors in place of the
pytree. Semantic, keyword and logical edges live in separate fixed-width
tables, so any path combination can be toggled at query time.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.knn_graph import KnnConfig
from repro_torch.core.pruning import PruneConfig
from repro_torch.core.usms import FusedVectors


@dataclasses.dataclass(frozen=True)
class BuildConfig:
    knn: KnnConfig = KnnConfig()
    prune: PruneConfig = PruneConfig()
    n_entry: int = 16  # large-norm entry points (paper §4.2.1)
    path_refine_iters: int = 2  # per-path NN-Descent rounds (single-path slots)
    logical_cap: int = 16
    entity_doc_cap: int = 8


INDEX_FIELDS = (
    "semantic_edges",
    "keyword_edges",
    "logical_edges",
    "doc_entities",
    "entity_to_docs",
    "entity_adj",
    "entry_points",
    "alive",
    "self_ip",
)


@dataclasses.dataclass
class HybridIndex:
    corpus: FusedVectors  # (N, ...)
    semantic_edges: torch.Tensor  # (N, d) int32
    keyword_edges: torch.Tensor  # (N, dk) int32
    logical_edges: torch.Tensor  # (N, L, 4) int32
    doc_entities: torch.Tensor  # (N, Ed) int32
    entity_to_docs: torch.Tensor  # (E, M) int32
    entity_adj: torch.Tensor  # (E, E) bool, dense (see ROADMAP: a limit at large E)
    entry_points: torch.Tensor  # (n_entry,) int32
    alive: torch.Tensor  # (N,) bool, mark-deletion
    self_ip: torch.Tensor  # (N,) IP(v, v)

    @property
    def n(self) -> int:
        return self.semantic_edges.shape[0]

    @property
    def degree(self) -> int:
        return self.semantic_edges.shape[1]

    def _leaves(self):
        return list(self.corpus.tensors()) + [getattr(self, f) for f in INDEX_FIELDS]

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self._leaves())

    def edge_nbytes(self) -> dict:
        """Index-only storage (excludes raw vectors), paper Table 2 metric."""
        nb = lambda t: t.numel() * t.element_size()
        return {
            "semantic": nb(self.semantic_edges),
            "keyword": nb(self.keyword_edges),
            "logical": nb(self.logical_edges),
            "entity_maps": nb(self.entity_to_docs) + nb(self.entity_adj),
            "vectors": sum(nb(t) for t in self.corpus.tensors()),
        }


def mark_deleted(index: HybridIndex, ids) -> HybridIndex:
    """Mark-deletion: nodes stay traversable, filtered from results
    (paper §4.1). Negative ids (PAD slots) are ignored."""
    ids = torch.as_tensor(ids, dtype=torch.long, device=index.alive.device).reshape(-1)
    ids = ids[(ids >= 0) & (ids < index.alive.shape[0])]
    alive = index.alive.clone()
    alive[ids] = False
    return dataclasses.replace(index, alive=alive)
