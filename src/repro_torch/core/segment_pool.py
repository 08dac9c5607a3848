"""Segment pool: a variable-length collection of sealed segments. Port of the
single-device parts of ``repro/core/segment_pool.py``.

A ``SegmentPool`` holds several shape groups, each a stacked
``SegmentedIndex``: segments of equal per-row capacity share a group and are
searched together by one group search under one cache key; different
capacities live in different groups. Group results merge per row in GLOBAL-id space, so a pool
search is a segment search with more segments. Appending a segment touches at
most one group; every other group is reused by reference, so its cache key
stays valid.

Placement over a mesh (``pool_placement``, ``place_pool``) follows
``repro``'s rule: a group shards over the mesh's segment axes if and only if
the mesh has more than one segment device and the group's segment count is
a multiple of that count; each device then owns a contiguous block of its
segments. Every other group stays whole on the coordinator (rank 0), which
serves it with the collective-free local pass.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import obs
from repro_torch.core.build_pipeline import BuildDraws, build_index, pad_index_rows
from repro_torch.core.distributed import (
    SegmentedIndex,
    alive_docs,
    mark_deleted_segmented,
    mesh_segment_count,
    place_segmented_index,
    resolve_global_ids,
)
from repro_torch.core.index import BuildConfig
from repro_torch.launch.mesh import mesh_device
from repro_torch.core.usms import PAD_IDX, FusedVectors, cat_fused, quantize_corpus


@dataclasses.dataclass
class SegmentPool:
    """A list of shape groups, each a stacked ``SegmentedIndex``: group g
    holds ``groups[g].n_segments`` segments of capacity
    ``groups[g].global_ids.shape[1]``."""

    groups: list[SegmentedIndex]

    @classmethod
    def from_segmented(cls, seg: SegmentedIndex) -> "SegmentPool":
        """Wrap a stacked index as a single-group pool (no copy)."""
        return cls(groups=[seg])

    @property
    def n_groups(self) -> int:
        return len(self.groups)

    @property
    def n_segments(self) -> int:
        return sum(g.n_segments for g in self.groups)

    @property
    def capacities(self) -> tuple[int, ...]:
        return tuple(int(g.global_ids.shape[1]) for g in self.groups)

    @property
    def entity_width(self) -> int:
        """Widest doc-entity row across groups."""
        return max(int(g.index.doc_entities.shape[-1]) for g in self.groups)

    @property
    def has_kg(self) -> bool:
        return any(g.index.entity_adj.shape[-1] > 1 for g in self.groups)

    def max_global_id(self) -> int:
        """Largest global doc id present, or -1 for an all-pad pool."""
        return max((int(g.global_ids.max()) for g in self.groups), default=-1)

    def segments(self) -> list[tuple[int, int]]:
        """Flat (group, local segment) enumeration of every pooled segment."""
        return [(g, s) for g, grp in enumerate(self.groups) for s in range(grp.n_segments)]


def _shapes(group: SegmentedIndex, skip: int = 0) -> tuple:
    return tuple(tuple(t.shape[skip:]) for t in group.leaves())


def group_shape_key(group: SegmentedIndex) -> tuple:
    """Exact shape signature of a group (storage dtypes included) — the
    the service's cache-key material."""
    return ("seg", type(group.index.corpus).__name__) + _shapes(group)


# ---------------------------------------------------------------------------
# Global-id routing over a pool (deletion, compaction, introspection)
# ---------------------------------------------------------------------------


def resolve_global_ids_pool(pool: SegmentPool, ids) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Global doc id -> (group, segment-in-group, local row); all -1 when the
    id lives nowhere in the pool."""
    ids = np.atleast_1d(np.asarray(ids, np.int64))
    grp = np.full(ids.shape, -1, np.int32)
    seg = np.full(ids.shape, -1, np.int32)
    loc = np.full(ids.shape, -1, np.int32)
    for g, group in enumerate(pool.groups):
        todo = grp < 0
        if not todo.any():
            break
        s, l = resolve_global_ids(group, ids[todo])
        hit = s >= 0
        idx = np.flatnonzero(todo)[hit]
        grp[idx] = g
        seg[idx] = s[hit]
        loc[idx] = l[hit]
    return grp, seg, loc


def mark_deleted_pool(
    pool: SegmentPool,
    ids,
    *,
    resolved: Optional[tuple[np.ndarray, np.ndarray, np.ndarray]] = None,
) -> SegmentPool:
    """Tombstone docs by global id wherever they live; shapes unchanged in
    every group. Unknown ids are ignored."""
    grp, seg, loc = resolved if resolved is not None else resolve_global_ids_pool(pool, ids)
    groups = list(pool.groups)
    for g in range(len(groups)):
        mine = grp == g
        if mine.any():
            groups[g] = mark_deleted_segmented(groups[g], None, resolved=(seg[mine], loc[mine]))
    return SegmentPool(groups=groups)


def widen_entities(ents: np.ndarray, width: int) -> np.ndarray:
    """Pad (or clip) doc-entity rows to ``width`` columns with PAD_IDX."""
    ents = np.asarray(ents, np.int32)
    if ents.shape[-1] == width:
        return ents
    out = np.full((ents.shape[0], width), PAD_IDX, np.int32)
    w = min(width, ents.shape[-1])
    out[:, :w] = ents[:, :w]
    return out


def alive_docs_pool(pool: SegmentPool) -> tuple[FusedVectors, np.ndarray, np.ndarray]:
    """Every live doc in the pool: (fp32 corpus rows, global ids, doc-entity
    rows padded to the pool's widest entity row) — the full-rebuild input."""
    width = pool.entity_width
    parts, gid_parts, ent_parts = [], [], []
    for group in pool.groups:
        corpus, gids, ents = alive_docs(group)
        parts.append(corpus)
        gid_parts.append(gids)
        ent_parts.append(widen_entities(ents, width))
    return cat_fused(parts), np.concatenate(gid_parts), np.concatenate(ent_parts, axis=0)


def live_counts(pool: SegmentPool) -> list[tuple[int, int, int, int]]:
    """Per pooled segment: (group, segment-in-group, capacity, live docs)."""
    out = []
    for g, group in enumerate(pool.groups):
        alive = group.index.alive.sum(dim=1).cpu().numpy()
        cap = int(group.global_ids.shape[1])
        for s in range(group.n_segments):
            out.append((g, s, cap, int(alive[s])))
    return out


# ---------------------------------------------------------------------------
# Pool surgery: build one segment, append it, remove segments
# ---------------------------------------------------------------------------


def build_pool_segment(
    corpus: FusedVectors,
    global_ids,
    cfg: BuildConfig = BuildConfig(),
    *,
    capacity: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
    draws: Optional[BuildDraws] = None,
    kg_triplets: Optional[np.ndarray] = None,
    doc_entities: Optional[np.ndarray] = None,
    n_entities: int = 0,
    corpus_dtype: str = "float32",
    device=None,
) -> SegmentedIndex:
    """Build ONE sealed segment on ``device`` (``None`` -> CUDA): a
    single-segment stacked index (leaves (1, ...)) padded to ``capacity``
    with dead rows, carrying the caller's global ids. The build is always
    fp32; ``corpus_dtype="int8"`` quantizes the stored corpus afterwards
    (the seal-time contract). Spans ``seal`` > ``build`` (``build_index``'s)
    and ``seal.pad_quantize`` under an active ``obs.tracing`` context."""
    global_ids = np.asarray(global_ids, np.int32)
    n = corpus.n
    if n == 0:
        raise ValueError("a pool segment needs at least one row")
    if global_ids.shape[0] != n:
        raise ValueError("global_ids must map every corpus row")
    if corpus_dtype not in ("float32", "int8"):
        raise ValueError(f"unknown corpus_dtype {corpus_dtype!r}")
    capacity = n if capacity is None else int(capacity)
    if capacity < n:
        raise ValueError(f"capacity {capacity} below row count {n}")
    kg_kwargs = {}
    if kg_triplets is not None and doc_entities is not None and n_entities > 0:
        kg_kwargs = dict(kg_triplets=kg_triplets, doc_entities=doc_entities,
                         n_entities=n_entities)
    with obs.span("seal", n=n, capacity=capacity, corpus_dtype=corpus_dtype):
        idx = build_index(corpus, cfg, generator=generator, draws=draws, device=device,
                          **kg_kwargs)
        with obs.span("seal.pad_quantize"):
            idx = pad_index_rows(idx, capacity)
            # entry points are built at min(cfg.n_entry, n): cycle them to the
            # capacity-determined length so equal-capacity segments stack
            n_entry = min(cfg.n_entry, capacity)
            ep = idx.entry_points
            if ep.shape[0] < n_entry:
                reps = -(-n_entry // ep.shape[0])
                idx = dataclasses.replace(idx, entry_points=ep.repeat(reps)[:n_entry])
            if corpus_dtype == "int8":
                idx = dataclasses.replace(idx, corpus=quantize_corpus(idx.corpus))
            gids = np.full((capacity,), PAD_IDX, np.int32)
            gids[:n] = global_ids
            seg = SegmentedIndex(idx, torch.as_tensor(gids, device=idx.alive.device))
            return seg.map(lambda t: t[None])


def append_segment(pool: SegmentPool, segment: SegmentedIndex) -> tuple[SegmentPool, int]:
    """Add sealed segments to the pool: they join the group whose
    per-segment shapes (and storage type) they match, else form a new group.
    Returns (new pool, index of the touched group)."""
    key = (type(segment.index.corpus), _shapes(segment, 1))
    groups = list(pool.groups)
    for g, group in enumerate(groups):
        if key == (type(group.index.corpus), _shapes(group, 1)):
            it = iter(segment.leaves())
            groups[g] = group.map(lambda t: torch.cat([t, next(it)]))
            return SegmentPool(groups=groups), g
    groups.append(segment)
    return SegmentPool(groups=groups), len(groups) - 1


def remove_segments(pool: SegmentPool, picks: Sequence[tuple[int, int]]) -> SegmentPool:
    """Drop the (group, segment-in-group) picks. Groups losing all segments
    disappear; untouched groups are reused by reference."""
    by_group: dict[int, set[int]] = {}
    for g, s in picks:
        by_group.setdefault(g, set()).add(s)
    groups = []
    for g, group in enumerate(pool.groups):
        drop = by_group.get(g)
        if not drop:
            groups.append(group)
            continue
        keep = [s for s in range(group.n_segments) if s not in drop]
        if keep:
            sel = torch.as_tensor(keep, dtype=torch.long, device=group.global_ids.device)
            groups.append(group.map(lambda t: t.index_select(0, sel)))
    return SegmentPool(groups=groups)


def extract_segment_docs(pool: SegmentPool, g: int, s: int):
    """Live docs of one pooled segment (corpus rows, global ids, entity rows)."""
    return alive_docs(pool.groups[g].map(lambda t: t[s:s + 1]))


# ---------------------------------------------------------------------------
# Placement: logical segments -> devices (many per device)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GroupPlacement:
    """Where one shape group's segments live.

    ``sharded=True``: the group's leading axis is split over the mesh's
    segment axes, ``devices[s]`` the segment-axes device index serving
    segment s (each device owns a contiguous block of ``n_segments /
    mesh_segment_count`` segments). ``sharded=False``: the group stays whole
    on the coordinator, served by the collective-free local group search."""

    group: int
    n_segments: int
    capacity: int
    sharded: bool
    devices: tuple[int, ...]


def group_shards(n_segments: int, mesh) -> bool:
    """The placement rule: a group of ``n_segments`` shards over the mesh
    iff the mesh has more than one segment device and the count is a
    multiple of theirs."""
    msc = mesh_segment_count(mesh) if mesh is not None else 1
    return msc > 1 and n_segments % msc == 0


def pool_placement(pool: SegmentPool, mesh=None) -> list[GroupPlacement]:
    """The placement map: which device serves which pooled segment
    (``group_shards`` decides each group)."""
    msc = mesh_segment_count(mesh) if mesh is not None else 1
    out = []
    for g, group in enumerate(pool.groups):
        n_seg = group.n_segments
        sharded = group_shards(n_seg, mesh)
        devices = tuple(s // (n_seg // msc) for s in range(n_seg)) if sharded else (0,) * n_seg
        out.append(GroupPlacement(group=g, n_segments=n_seg,
                                  capacity=int(group.global_ids.shape[1]), sharded=sharded,
                                  devices=devices))
    return out


def place_pool(pool: SegmentPool, mesh=None) -> SegmentPool:
    """This rank's part of the pool per the placement map, on its device: a
    sharded group's block (``place_segmented_index``); every other group
    whole on the coordinator (rank 0) and, on the other ranks, an empty
    slice of it (0 segments), so group indices agree on every rank. Off
    the mesh, the pool itself."""
    if mesh is None:
        return pool
    coordinator = dist.get_rank() == 0
    groups = []
    for group, pl in zip(pool.groups, pool_placement(pool, mesh)):
        if pl.sharded:
            groups.append(place_segmented_index(group, mesh))
        else:
            dev = mesh_device(mesh)
            groups.append(group.map(lambda t: (t if coordinator else t[:0]).to(dev)))
    return SegmentPool(groups=groups)
