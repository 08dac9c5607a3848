"""Segmented indexes on one GPU. Port of the single-device parts of
``repro/core/distributed.py``.

A ``SegmentedIndex`` stacks S same-shape segment indexes on a leading axis:
every leaf of its ``HybridIndex`` has shape (S, ...), and ``global_ids``
(S, n_seg) maps each segment's local rows to original doc ids (PAD on pad
rows). Graphs never cross segments. ``make_local_group_search`` searches the
S segments and merges their top-k per row in global-id space, fusion-aware
(``fusion.merge_rows_fused``). ``repro`` vmaps the segments into one traced
program; here the S segments are searched as ONE index of S x n_seg rows
(``SegmentedIndex.flat``: views of the stacked tensors, edge ids offset by
segment) with the queries repeated per segment and each row starting from
its own segment's entry points, so a group costs one round loop on the host
whatever its segment count. A KG search runs the segments in turn: entity
tables address a segment's local rows. The mesh builders, the ``shard_map``
search and placement belong to the multi-GPU slice.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core.build_pipeline import BuildDraws, build_index
from repro_torch.core.fusion import FusionSpec, PathStats, broadcast_spec, merge_rows_fused
from repro_torch.core.index import INDEX_FIELDS, BuildConfig, HybridIndex
from repro_torch.core.search import SearchParams, SearchResult, search_padded
from repro_torch.core.usms import (
    PAD_IDX,
    FusedVectors,
    PathWeights,
    QuantizedFusedVectors,
    SparseVec,
    dequantize_corpus,
)
from repro_torch.kernels.ref import topk_desc

NEG_FILL = -1e30


def map_corpus(corpus, fn):
    """Apply ``fn`` to every tensor of a (possibly quantized) corpus."""
    t = corpus.tensors()
    if isinstance(corpus, QuantizedFusedVectors):
        return QuantizedFusedVectors(fn(t[0]), fn(t[1]), SparseVec(fn(t[2]), fn(t[3])),
                                     SparseVec(fn(t[4]), fn(t[5])))
    return FusedVectors(fn(t[0]), SparseVec(fn(t[1]), fn(t[2])), SparseVec(fn(t[3]), fn(t[4])))


def map_index(index: HybridIndex, fn) -> HybridIndex:
    """Apply ``fn`` to every tensor of an index (corpus included)."""
    return HybridIndex(corpus=map_corpus(index.corpus, fn),
                       **{f: fn(getattr(index, f)) for f in INDEX_FIELDS})


def stack_indexes(indexes: Sequence[HybridIndex]) -> HybridIndex:
    """Stack same-shape indexes leaf by leaf on a new leading axis."""
    leaves = [i._leaves() for i in indexes]
    cols = [torch.stack([lv[j] for lv in leaves]) for j in range(len(leaves[0]))]
    it = iter(cols)
    return map_index(indexes[0], lambda _: next(it))


@dataclasses.dataclass
class SegmentedIndex:
    """Per-segment hybrid indexes stacked on a leading segment axis.

    index: HybridIndex whose tensors have shape (S, ...).
    global_ids: (S, n_seg) int32 mapping local row -> original doc id.
    """

    index: HybridIndex
    global_ids: torch.Tensor

    @property
    def n_segments(self) -> int:
        return self.global_ids.shape[0]

    def leaves(self) -> list[torch.Tensor]:
        return self.index._leaves() + [self.global_ids]

    def segment(self, s: int) -> HybridIndex:
        """Segment s as a plain HybridIndex of views into the stacked tensors."""
        return map_index(self.index, lambda t: t[s])

    def map(self, fn) -> "SegmentedIndex":
        """Apply ``fn`` to every tensor (global ids included)."""
        return SegmentedIndex(map_index(self.index, fn), fn(self.global_ids))

    @functools.cached_property
    def flat(self) -> tuple[HybridIndex, torch.Tensor]:
        """The S segments as one index of S * n_seg rows, and each segment's
        entry points in its ids, (S, n_entry). Leaves are views of the
        stacked tensors except the two edge tables, whose ids are offset by
        segment (PAD stays PAD); made once per group object (a delete or a
        compaction publishes a new one). The entity tables stay per segment,
        so the flattened index serves no KG search."""
        idx, cap = self.index, self.global_ids.shape[1]
        off = torch.arange(self.n_segments, dtype=torch.int32,
                           device=self.global_ids.device)[:, None] * cap
        flat = lambda t: t.reshape((-1,) + tuple(t.shape[2:]))

        def shifted(t):
            o = off.view((-1,) + (1,) * (t.dim() - 1)).to(t.dtype)
            return flat(torch.where(t >= 0, t + o, t))

        flat_index = HybridIndex(
            corpus=map_corpus(idx.corpus, flat),
            semantic_edges=shifted(idx.semantic_edges),
            keyword_edges=shifted(idx.keyword_edges),
            logical_edges=flat(idx.logical_edges), doc_entities=flat(idx.doc_entities),
            entity_to_docs=idx.entity_to_docs[0], entity_adj=idx.entity_adj[0],
            entry_points=idx.entry_points[0], alive=flat(idx.alive), self_ip=flat(idx.self_ip))
        entries = torch.where(idx.entry_points >= 0, idx.entry_points + off, idx.entry_points)
        return flat_index, entries


def segment_slices(n: int, n_segments: int) -> list[tuple[int, int]]:
    """Contiguous per-segment (lo, hi) slices; trailing segments may be EMPTY
    (lo == hi) when n < n_segments * ceil(n / n_segments)."""
    per = -(-n // n_segments)  # ceil
    return [(min(s * per, n), min((s + 1) * per, n)) for s in range(n_segments)]


def shard_corpus(corpus, n_segments: int) -> tuple[list, np.ndarray]:
    """Split a corpus into equal segments (the last one zero-padded, as
    ``repro`` pads). Returns per-segment corpora and the (S, n_seg) global id
    map."""
    n = corpus.n
    per = -(-n // n_segments)
    gids = np.full((n_segments, per), PAD_IDX, np.int32)
    parts = []
    for s, (lo, hi) in enumerate(segment_slices(n, n_segments)):
        gids[s, : hi - lo] = np.arange(lo, hi)
        part = corpus[lo:hi]
        pad = per - (hi - lo)
        if pad:
            part = map_corpus(part, lambda a: torch.cat(
                [a, torch.zeros((pad,) + tuple(a.shape[1:]), dtype=a.dtype, device=a.device)]))
        parts.append(part)
    return parts, gids


def build_segmented_index(
    corpus: FusedVectors,
    n_segments: int,
    cfg: BuildConfig = BuildConfig(),
    *,
    generator: Optional[torch.Generator] = None,
    draws: Optional[Sequence[Optional[BuildDraws]]] = None,
    kg_triplets: Optional[np.ndarray] = None,
    doc_entities: Optional[np.ndarray] = None,
    n_entities: int = 0,
    device=None,
) -> SegmentedIndex:
    """Build every segment's index independently, one after another, and
    stack them. ``draws[s]`` (optional) are segment s's random draws; the
    rest come from ``generator``."""
    parts, gids = shard_corpus(corpus, n_segments)
    indexes = []
    for s, part in enumerate(parts):
        kg_kwargs = {}
        if kg_triplets is not None and doc_entities is not None:
            lo, hi = segment_slices(corpus.n, n_segments)[s]
            ents = np.full((part.n, np.asarray(doc_entities).shape[1]), PAD_IDX, np.int32)
            ents[: hi - lo] = np.asarray(doc_entities)[lo:hi]
            kg_kwargs = dict(kg_triplets=kg_triplets, doc_entities=ents, n_entities=n_entities)
        idx = build_index(part, cfg, generator=generator,
                          draws=None if draws is None else draws[s], device=device, **kg_kwargs)
        valid = torch.as_tensor(gids[s] >= 0, device=idx.alive.device)
        indexes.append(dataclasses.replace(idx, alive=idx.alive & valid))
    stacked = stack_indexes(indexes)
    return SegmentedIndex(stacked, torch.as_tensor(gids, device=stacked.alive.device))


# ---------------------------------------------------------------------------
# Global-id routing: deletion and compaction resolve original doc ids back to
# (segment, local row) on the host.
# ---------------------------------------------------------------------------


def resolve_global_ids(seg_index: SegmentedIndex, ids) -> tuple[np.ndarray, np.ndarray]:
    """Host-side routing: global doc id -> (segment, local row); ids not
    present resolve to (-1, -1). A searchsorted over the sorted valid ids:
    compaction leaves gaps in the id space."""
    gids = seg_index.global_ids.cpu().numpy()
    per = gids.shape[1]
    flat = gids.reshape(-1)
    valid_pos = np.flatnonzero(flat >= 0)
    ids = np.atleast_1d(np.asarray(ids, np.int64))
    if valid_pos.size == 0:
        none = np.full(ids.shape, -1, np.int32)
        return none, none.copy()
    order = np.argsort(flat[valid_pos], kind="stable")
    sorted_g = flat[valid_pos][order]
    pos = valid_pos[order]
    j = np.clip(np.searchsorted(sorted_g, ids), 0, sorted_g.size - 1)
    found = (sorted_g[j] == ids) & (ids >= 0)
    p = np.where(found, pos[j], -1)
    seg = np.where(found, p // per, -1).astype(np.int32)
    loc = np.where(found, p % per, -1).astype(np.int32)
    return seg, loc


def mark_deleted_segmented(
    seg_index: SegmentedIndex,
    global_ids,
    *,
    resolved: Optional[tuple[np.ndarray, np.ndarray]] = None,
) -> SegmentedIndex:
    """Tombstone docs by GLOBAL id (a new alive mask; shapes unchanged, so
    the service's cache keys stay valid). Unresolved ids are ignored. Pass
    ``resolved=(seg, loc)`` when the caller already routed the ids."""
    seg, loc = resolved if resolved is not None else resolve_global_ids(seg_index, global_ids)
    ok = np.asarray(seg) >= 0
    alive = seg_index.index.alive.clone()
    dev = alive.device
    alive[torch.as_tensor(np.asarray(seg)[ok], dtype=torch.long, device=dev),
          torch.as_tensor(np.asarray(loc)[ok], dtype=torch.long, device=dev)] = False
    return SegmentedIndex(dataclasses.replace(seg_index.index, alive=alive),
                          seg_index.global_ids)


def alive_docs(seg_index: SegmentedIndex) -> tuple[FusedVectors, np.ndarray, np.ndarray]:
    """The live (non-pad, non-tombstoned) docs of every segment: (corpus rows
    on the index's device, their global ids, their doc-entity rows) — the
    compaction input. Quantized storage is dequantized here: every rebuild
    input is fp32."""
    gids = seg_index.global_ids.cpu().numpy().reshape(-1)
    alive = seg_index.index.alive.cpu().numpy().reshape(-1)
    rows = np.flatnonzero((gids >= 0) & alive)
    sel = torch.as_tensor(rows, dtype=torch.long, device=seg_index.global_ids.device)
    corpus = map_corpus(seg_index.index.corpus,
                        lambda a: a.reshape((-1,) + tuple(a.shape[2:]))[sel])
    if isinstance(corpus, QuantizedFusedVectors):
        corpus = dequantize_corpus(corpus)
    ents = seg_index.index.doc_entities.cpu().numpy()
    ents = ents.reshape((-1, ents.shape[-1]))[rows]
    return corpus, gids[rows].astype(np.int32), ents


def compact_segmented_index(
    corpus: FusedVectors,
    global_ids,
    n_segments: int,
    cfg: BuildConfig = BuildConfig(),
    *,
    generator: Optional[torch.Generator] = None,
    draws: Optional[Sequence[Optional[BuildDraws]]] = None,
    kg_triplets: Optional[np.ndarray] = None,
    doc_entities: Optional[np.ndarray] = None,
    n_entities: int = 0,
    device=None,
) -> SegmentedIndex:
    """Rebuild a corpus of surviving docs into a fresh S-segment index,
    PRESERVING the caller's global ids (positions change, identities don't).
    Pass the knowledge graph to rebuild the logical edges too."""
    global_ids = np.asarray(global_ids, np.int32)
    if corpus.n == 0:
        raise ValueError("cannot compact an empty corpus (all docs deleted)")
    if global_ids.shape[0] != corpus.n:
        raise ValueError("global_ids must map every corpus row")
    seg = build_segmented_index(
        corpus, n_segments, cfg, generator=generator, draws=draws, kg_triplets=kg_triplets,
        doc_entities=doc_entities, n_entities=n_entities, device=device)
    per = seg.global_ids.shape[1]
    new_g = np.full((n_segments, per), PAD_IDX, np.int32)
    for s, (lo, hi) in enumerate(segment_slices(corpus.n, n_segments)):
        new_g[s, : hi - lo] = global_ids[lo:hi]
    return SegmentedIndex(seg.index, torch.as_tensor(new_g, device=seg.global_ids.device))


# ---------------------------------------------------------------------------
# Search over a stacked group of segments
# ---------------------------------------------------------------------------


def _segment_to_global(
    idx: HybridIndex,
    gids: torch.Tensor,
    queries: FusedVectors,
    fusion: FusionSpec,
    keywords: torch.Tensor,
    entities: torch.Tensor,
    params: SearchParams,
):
    """One segment's search with local row ids mapped to GLOBAL doc ids
    (-inf scores on pad slots); per-path scores ride along for the
    fusion-aware merge."""
    res = search_padded(idx, queries, fusion, keywords, entities, params)
    g = torch.where(res.ids >= 0, gids[res.ids.clamp(0, gids.shape[0] - 1).long()], PAD_IDX)
    scores = torch.where(g >= 0, res.scores, float("-inf"))
    ps = torch.where((g >= 0)[:, :, None], res.path_scores, 0.0)
    return g, scores, ps, res.expanded


def _tile(x, s: int):
    """Rows repeated s times, segment-major (a tensor, a fusion spec's
    leaves or a corpus)."""
    if isinstance(x, torch.Tensor):
        return torch.cat([x] * s)
    if isinstance(x, FusionSpec):
        return FusionSpec(mode=_tile(x.mode, s), weights=_tile(x.weights, s),
                          rrf_k=_tile(x.rrf_k, s), stats=_tile(x.stats, s))
    if isinstance(x, PathWeights):
        return PathWeights(*(_tile(getattr(x, f), s) for f in ("dense", "sparse", "full", "kg")))
    if isinstance(x, PathStats):
        return PathStats(*(_tile(getattr(x, f), s) for f in ("minv", "maxv", "mean", "std")))
    return map_corpus(x, lambda t: _tile(t, s))


def _group_to_global(seg_index, queries, spec, keywords, entities, params):
    """All S segments in one search: (S, B, k) global ids, scores, per-path
    scores, and the total expansions."""
    s, b = seg_index.n_segments, queries.n
    flat_index, entries = seg_index.flat
    res = search_padded(flat_index, _tile(queries, s), _tile(spec, s), _tile(keywords, s),
                        _tile(entities, s), params,
                        entry_points=entries.repeat_interleave(b, dim=0))
    gids = seg_index.global_ids.reshape(-1)
    g = torch.where(res.ids >= 0, gids[res.ids.clamp(0, gids.shape[0] - 1).long()], PAD_IDX)
    scores = torch.where(g >= 0, res.scores, float("-inf"))
    ps = torch.where((g >= 0)[:, :, None], res.path_scores, 0.0)
    shape = (s, b) + tuple(g.shape[1:])
    return (g.reshape(shape), scores.reshape(shape), ps.reshape(shape + (3,)),
            res.expanded.sum())


def _merge_rows_topk(g_all: torch.Tensor, s_all: torch.Tensor, k: int):
    """Per-row top-k over stacked (S, B, k) global-id results by raw score:
    (top scores, ids), PAD ids on non-finite slots. Correct for weighted and
    normalized fusion only; RRF goes through ``merge_rows_fused``."""
    b = g_all.shape[1]
    g_flat = g_all.movedim(0, 1).reshape(b, -1)
    s_flat = s_all.movedim(0, 1).reshape(b, -1)
    top, pos = topk_desc(s_flat, k)
    ids = torch.where(torch.isfinite(top), torch.gather(g_flat, 1, pos), PAD_IDX)
    return top, ids


def make_local_group_search(params: SearchParams):
    """The search callable for a stacked ``SegmentedIndex`` (a segment-pool
    group) on one device: ``search_padded`` per segment, then the per-row
    fusion-aware merge in global-id space.

    Returns fn(seg_index, queries, fusion, keywords, entities) ->
    SearchResult; ``expanded`` is the whole-batch total broadcast per row,
    as in ``repro``."""
    def run(
        seg_index: SegmentedIndex,
        queries: FusedVectors,
        fusion: Union[FusionSpec, PathWeights],
        keywords: torch.Tensor,
        entities: torch.Tensor,
    ) -> SearchResult:
        if isinstance(fusion, PathWeights):
            fusion = FusionSpec.from_weights(fusion)
        dev = seg_index.global_ids.device
        spec = broadcast_spec(fusion, queries.n, dev)
        if params.use_kg:  # per-segment entity tables: one segment at a time
            parts = [
                _segment_to_global(seg_index.segment(s), seg_index.global_ids[s], queries,
                                   spec, keywords, entities, params)
                for s in range(seg_index.n_segments)
            ]
            g_all, s_all, ps_all = (torch.stack([p[i] for p in parts]) for i in range(3))
            total = sum(p[3].sum() for p in parts)
        else:
            g_all, s_all, ps_all, total = _group_to_global(
                seg_index, queries.to(dev), spec, keywords.to(dev, torch.int32),
                entities.to(dev, torch.int32), params)
        ids, top, ps = merge_rows_fused(g_all, s_all, ps_all, spec, params.k)
        scores = torch.where(torch.isfinite(top), top, NEG_FILL)
        expanded = total.to(torch.int32).expand(ids.shape[0]).contiguous()
        return SearchResult(ids, scores, expanded, ps)

    return run
