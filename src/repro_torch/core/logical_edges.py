"""Logical edge augmentation from a knowledge graph (paper §3.4, §4.1 Step 4).
Numpy copy of ``repro/core/logical_edges.py`` (host-side; the builder moves
the tables to the device).

For each index node X the logical edges are the triplets
{(s, r, t) | s ∈ V(X), t ∈ V \\ V(X)}, stored as fixed-width per-node tables
``(L, 4)`` int32 rows (dst_doc, src_entity, rel, dst_entity), plus
``entity_to_docs`` (E, M) and the dense ``entity_adj`` (E, E) bool.
"""

from __future__ import annotations

import dataclasses

import numpy as np

PAD_IDX = -1


@dataclasses.dataclass
class LogicalEdges:
    edges: np.ndarray  # (N, L, 4) int32: dst_doc, src_ent, rel, dst_ent
    entity_to_docs: np.ndarray  # (E, M) int32
    entity_adj: np.ndarray  # (E, E) bool
    doc_entities: np.ndarray  # (N, Ed) int32

    @classmethod
    def empty(cls, n_docs: int, l_cap: int = 1, n_entities: int = 1, m_cap: int = 1):
        return cls(
            np.full((n_docs, l_cap, 4), PAD_IDX, np.int32),
            np.full((n_entities, m_cap), PAD_IDX, np.int32),
            np.zeros((n_entities, n_entities), bool),
            np.full((n_docs, 1), PAD_IDX, np.int32),
        )


def build_logical_edges(
    triplets: np.ndarray,  # (T, 3) (src_ent, rel, dst_ent)
    doc_entities: np.ndarray,  # (N, Ed) int32 PAD-padded
    n_entities: int,
    l_cap: int = 16,
    m_cap: int = 8,
) -> LogicalEdges:
    n_docs = doc_entities.shape[0]
    triplets = np.asarray(triplets, np.int32).reshape(-1, 3)

    # entity -> docs
    ent_docs: list[list[int]] = [[] for _ in range(n_entities)]
    for d in range(n_docs):
        for e in doc_entities[d]:
            if e >= 0 and len(ent_docs[e]) < m_cap:
                ent_docs[e].append(d)
    entity_to_docs = np.full((n_entities, m_cap), PAD_IDX, np.int32)
    for e, ds in enumerate(ent_docs):
        entity_to_docs[e, : len(ds)] = ds

    # symmetric adjacency (relations are traversable both ways for retrieval)
    adj = np.zeros((n_entities, n_entities), bool)
    if len(triplets):
        adj[triplets[:, 0], triplets[:, 2]] = True
        adj[triplets[:, 2], triplets[:, 0]] = True

    # per-doc logical edge tables
    doc_ent_sets = [set(int(e) for e in row if e >= 0) for row in doc_entities]
    edges = np.full((n_docs, l_cap, 4), PAD_IDX, np.int32)
    fill = np.zeros(n_docs, np.int32)
    for s, r, t in triplets:
        for src_e, dst_e in ((s, t), (t, s)):  # both directions
            src_docs = ent_docs[src_e] if src_e < n_entities else []
            dst_docs = ent_docs[dst_e] if dst_e < n_entities else []
            for X in src_docs:
                for Y in dst_docs:
                    if Y == X or dst_e in doc_ent_sets[X]:
                        continue
                    if fill[X] < l_cap:
                        edges[X, fill[X]] = (Y, src_e, r, dst_e)
                        fill[X] += 1
    return LogicalEdges(edges, entity_to_docs, adj, np.asarray(doc_entities, np.int32))
