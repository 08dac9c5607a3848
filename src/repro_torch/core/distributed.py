"""Segmented indexes, on one GPU and over a device mesh. Port of
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
tables address a segment's local rows.

Over a mesh (``launch.mesh.make_mesh``, axes ``("pod", "data", "model")`` or
any subset), ``SEGMENT_AXES`` shard the segments and ``QUERY_AXIS`` shards
the query batch, as in ``repro``. ``repro`` runs one controller under
``shard_map``; the port runs one process per device, and this is its SPMD
contract:

  * **Calls.** Every rank calls each collective entry point here
    (``build_index_sharded``, ``compact_segmented_index(mesh=)``, the
    callables of ``make_distributed_search_padded`` /
    ``make_distributed_search`` / ``make_distributed_descent_round``) with
    the same arguments, in the same order.
  * **Placement.** ``place_segmented_index(seg, mesh)`` returns the rank's
    own contiguous block of ``S / mesh_segment_count(mesh)`` segments on the
    rank's device: rank r's row-major coordinate on the segment axes picks
    the block, as ``repro``'s ``_segment_spec`` splits the leading axis, and
    ``global_ids`` goes along with it. The search callables take that block.
  * **Results.** Every rank returns the whole batch's merged
    ``SearchResult`` in global ids (``repro``'s ``out_specs=P()``);
    ``expanded`` is the whole batch's total, summed over every axis and
    broadcast per row. A sharded build returns the whole ``SegmentedIndex``
    on every rank's device.
  * **Devices and backends.** A mesh on ``"cuda"`` runs NCCL, rank r on
    ``cuda:{LOCAL_RANK}``; a mesh on ``"cpu"`` runs gloo and exists only
    when the caller asks for it. CUDA tensors never go through gloo; a
    missing NCCL or a world size other than the mesh's raises. Nothing
    falls back.

Each rank searches its block with the flattened group pass of the local
search, all-gathers the per-segment (spd, B/m, k) ids, scores and path
scores over the segment axes, merges all S segments in one fusion-aware
pass (RRF re-ranks over the union, §11), and all-gathers the merged rows
over the model axis. A sharded build runs ``build_index`` for the rank's
segments with the draws ``build_segmented_index`` gives them (``draws[s]``,
or a generator seeded ``segment_seed(seed, s)``: ``repro``'s
``fold_in(key, s)``) and all-gathers the graph tables.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core.build_pipeline import BuildDraws, GraphArrays, build_graph, build_index
from repro_torch.core.knn_graph import KnnConfig, _descent_round_chunk
from repro_torch.core.logical_edges import LogicalEdges, build_logical_edges
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
from repro_torch.device import resolve_device
from repro_torch.kernels.ref import topk_desc
from repro_torch.launch.mesh import (
    all_gather_cat,
    all_reduce_sum,
    axis_group,
    axis_sizes,
    mesh_device,
)

NEG_FILL = -1e30
SEGMENT_AXES = ("pod", "data")  # axes that shard segments (the present subset)
QUERY_AXIS = "model"  # axis that shards the query batch


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


def stack_corpora(parts: Sequence):
    """Stack same-shape corpora leaf by leaf on a new leading axis."""
    cols = [torch.stack(c) for c in zip(*(p.tensors() for p in parts))]
    it = iter(cols)
    return map_corpus(parts[0], lambda _: next(it))


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


def segment_seed(seed: int, s: int) -> int:
    """The generator seed of segment s in a build seeded ``seed`` (the
    port's ``fold_in(key, s)``): a build of one segment draws as a build
    seeded ``seed``."""
    return int(seed) + s


def _segment_entities(doc_entities, n: int, n_segments: int, s: int, rows: int) -> np.ndarray:
    """Segment s's doc-entity rows, PAD-padded to ``rows``."""
    lo, hi = segment_slices(n, n_segments)[s]
    ents = np.full((rows, np.asarray(doc_entities).shape[1]), PAD_IDX, np.int32)
    ents[: hi - lo] = np.asarray(doc_entities)[lo:hi]
    return ents


def build_segmented_index(
    corpus: FusedVectors,
    n_segments: int,
    cfg: BuildConfig = BuildConfig(),
    *,
    generator: Optional[torch.Generator] = None,
    seed: Optional[int] = None,
    draws: Optional[Sequence[Optional[BuildDraws]]] = None,
    kg_triplets: Optional[np.ndarray] = None,
    doc_entities: Optional[np.ndarray] = None,
    n_entities: int = 0,
    device=None,
) -> SegmentedIndex:
    """Build every segment's index independently, one after another, and
    stack them. ``draws[s]`` (optional) are segment s's random draws; the
    rest come from ``generator`` (shared, in segment order) or, given
    ``seed``, from segment s's own generator seeded ``segment_seed(seed,
    s)``, as ``build_index_sharded`` draws them."""
    if generator is not None and seed is not None:
        raise ValueError("pass a generator or a seed, not both")
    parts, gids = shard_corpus(corpus, n_segments)
    indexes = []
    for s, part in enumerate(parts):
        kg_kwargs = {}
        if kg_triplets is not None and doc_entities is not None:
            kg_kwargs = dict(kg_triplets=kg_triplets, n_entities=n_entities,
                             doc_entities=_segment_entities(doc_entities, corpus.n, n_segments,
                                                            s, part.n))
        if seed is not None:
            generator = torch.Generator(device=resolve_device(device)).manual_seed(
                segment_seed(seed, s))
        idx = build_index(part, cfg, generator=generator,
                          draws=None if draws is None else draws[s], device=device, **kg_kwargs)
        valid = torch.as_tensor(gids[s] >= 0, device=idx.alive.device)
        indexes.append(dataclasses.replace(idx, alive=idx.alive & valid))
    stacked = stack_indexes(indexes)
    return SegmentedIndex(stacked, torch.as_tensor(gids, device=stacked.alive.device))


def mesh_segment_count(mesh) -> int:
    """Number of devices on the segment axes. Sharded builds and searches
    require the stacked segment count S to be a MULTIPLE of this (each
    device owns S / mesh_segment_count segments)."""
    sizes = axis_sizes(mesh)
    return int(np.prod([sizes[a] for a in SEGMENT_AXES if a in sizes]))


def _segment_block(mesh, n_segments: int) -> slice:
    """This rank's contiguous block of the leading segment axis."""
    msc = mesh_segment_count(mesh)
    if n_segments % msc:
        raise ValueError(
            f"n_segments={n_segments} must be a multiple of the segment-axes device count "
            f"{msc} (each device owns n_segments / {msc} segments)")
    ag = axis_group(mesh, SEGMENT_AXES)
    spd, c = n_segments // msc, (ag.index if ag is not None else 0)
    return slice(c * spd, (c + 1) * spd)


def place_segmented_index(seg_index: SegmentedIndex, mesh) -> SegmentedIndex:
    """This rank's block of the segmented index on its device: the
    contiguous S / mesh_segment_count(mesh) segments its coordinate on the
    segment axes picks, with their global ids."""
    block, dev = _segment_block(mesh, seg_index.n_segments), mesh_device(mesh)
    return seg_index.map(lambda t: t[block].to(dev))


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
    mesh=None,
    generator: Optional[torch.Generator] = None,
    seed: Optional[int] = None,
    draws: Optional[Sequence[Optional[BuildDraws]]] = None,
    kg_triplets: Optional[np.ndarray] = None,
    doc_entities: Optional[np.ndarray] = None,
    n_entities: int = 0,
    device=None,
) -> SegmentedIndex:
    """Rebuild a corpus of surviving docs into a fresh S-segment index,
    PRESERVING the caller's global ids (positions change, identities don't).
    Pass the knowledge graph to rebuild the logical edges too.

    Over a ``mesh`` whose segment-axes device count divides ``n_segments``
    the build is ``build_index_sharded`` (collective; ``seed``, default 0,
    and ``draws``), else the sequential ``build_segmented_index``."""
    global_ids = np.asarray(global_ids, np.int32)
    if corpus.n == 0:
        raise ValueError("cannot compact an empty corpus (all docs deleted)")
    if global_ids.shape[0] != corpus.n:
        raise ValueError("global_ids must map every corpus row")
    kg_kwargs = dict(kg_triplets=kg_triplets, doc_entities=doc_entities, n_entities=n_entities)
    if mesh is not None and n_segments % mesh_segment_count(mesh) == 0:
        if generator is not None:
            raise ValueError("a sharded build draws from a seed, not a generator")
        seg = build_index_sharded(corpus, n_segments, cfg, mesh=mesh,
                                  seed=0 if seed is None else seed, draws=draws, **kg_kwargs)
    else:
        seg = build_segmented_index(corpus, n_segments, cfg, generator=generator, seed=seed,
                                    draws=draws, device=device, **kg_kwargs)
    per = seg.global_ids.shape[1]
    new_g = np.full((n_segments, per), PAD_IDX, np.int32)
    for s, (lo, hi) in enumerate(segment_slices(corpus.n, n_segments)):
        new_g[s, : hi - lo] = global_ids[lo:hi]
    return SegmentedIndex(seg.index, torch.as_tensor(new_g, device=seg.global_ids.device))


# ---------------------------------------------------------------------------
# Segment-parallel construction (paper §4.1 at scale): every rank builds its
# block's segments with the program the single-device path runs; graphs
# never cross segments, so the only collective gathers the finished tables.
# ---------------------------------------------------------------------------


def make_sharded_graph_builder(mesh, cfg: BuildConfig):
    """The graph stages of a segmented build across the mesh (collective):
    fn(stacked_corpus, seed=0, draws=None) -> ``GraphArrays`` with leaves
    (S, ...) on every rank. Each rank runs ``build_graph`` over its block's
    segments one after another (segment s from ``draws[s]`` where given and
    a generator seeded ``segment_seed(seed, s)``), so its memory high-water
    stays one build; the tables are then all-gathered over the segment
    axes."""
    seg_ag = axis_group(mesh, SEGMENT_AXES)
    dev = mesh_device(mesh)

    def build(stacked, seed: int = 0, draws=None) -> GraphArrays:
        block = _segment_block(mesh, stacked.n)
        graphs = [
            build_graph(map_corpus(stacked, lambda t: t[s].to(dev)), cfg,
                        torch.Generator(device=dev).manual_seed(segment_seed(seed, s)),
                        draws=None if draws is None else draws[s])
            for s in range(block.start, block.stop)
        ]
        tables = {f.name: torch.stack([getattr(g, f.name) for g in graphs])
                  for f in dataclasses.fields(GraphArrays)}
        if seg_ag is not None:
            tables = {k: all_gather_cat(mesh, t, seg_ag) for k, t in tables.items()}
        return GraphArrays(**tables)

    return build


def build_index_sharded(
    corpus: FusedVectors,
    n_segments: int,
    cfg: BuildConfig = BuildConfig(),
    *,
    mesh,
    seed: int = 0,
    draws: Optional[Sequence[Optional[BuildDraws]]] = None,
    kg_triplets: Optional[np.ndarray] = None,
    doc_entities: Optional[np.ndarray] = None,
    n_entities: int = 0,
) -> SegmentedIndex:
    """Build the segments IN PARALLEL across the mesh (collective): the
    graph stages through ``make_sharded_graph_builder``, then each rank's
    segments' logical edges on the host, all-gathered, so every rank
    returns the whole ``SegmentedIndex`` on its device. Segment s draws
    ``draws[s]`` where given, the rest from a generator seeded
    ``segment_seed(seed, s)``: it equals ``build_segmented_index(...,
    seed=seed, draws=draws)`` segment by segment."""
    block = _segment_block(mesh, n_segments)  # raises unless the segments divide
    dev = mesh_device(mesh)
    parts, gids = shard_corpus(corpus.to(dev), n_segments)
    stacked = stack_corpora(parts)
    g = make_sharded_graph_builder(mesh, cfg)(stacked, seed, draws)
    per = gids.shape[1]
    logs = []
    for s in range(block.start, block.stop):
        if kg_triplets is not None and doc_entities is not None and n_entities > 0:
            logs.append(build_logical_edges(
                kg_triplets, _segment_entities(doc_entities, corpus.n, n_segments, s, per),
                n_entities, l_cap=cfg.logical_cap, m_cap=cfg.entity_doc_cap))
        else:
            logs.append(LogicalEdges.empty(per))
    log_fields = ("logical_edges", "doc_entities", "entity_to_docs", "entity_adj")
    log_attrs = ("edges", "doc_entities", "entity_to_docs", "entity_adj")
    tables = {f: torch.stack([torch.as_tensor(getattr(lg, a)) for lg in logs]).to(dev)
              for f, a in zip(log_fields, log_attrs)}
    seg_ag = axis_group(mesh, SEGMENT_AXES)
    if seg_ag is not None:
        tables = {f: all_gather_cat(mesh, t, seg_ag) for f, t in tables.items()}
    index = HybridIndex(corpus=stacked, semantic_edges=g.semantic_edges,
                        keyword_edges=g.keyword_edges, entry_points=g.entry_points,
                        alive=torch.as_tensor(gids >= 0, device=dev), self_ip=g.self_ip,
                        **tables)
    return SegmentedIndex(index, torch.as_tensor(gids, device=dev))


def make_distributed_descent_round(mesh, cfg: KnnConfig):
    """One lock-step NN-Descent round across the segments (collective):
    fn(corpus, nbr_ids, scores, rand_ids), each with a leading axis of one
    segment per segment-axes device, returns the round's (ids, scores) of
    every segment. Each rank runs one ``_descent_round_chunk`` over its
    segment on its device; the graphs are private, so the only collective
    gathers the results."""
    seg_ag = axis_group(mesh, SEGMENT_AXES)

    def run(corpus, nbr_ids, scores, rand_ids):
        msc = mesh_segment_count(mesh)
        if nbr_ids.shape[0] != msc:
            raise ValueError(
                f"{nbr_ids.shape[0]} segments for {msc} segment devices: one segment each")
        c, dev = _segment_block(mesh, msc).start, mesh_device(mesh)
        seg_corpus = map_corpus(corpus, lambda t: t[c].to(dev))
        nbr, sc, rnd = (x[c].to(dev) for x in (nbr_ids, scores, rand_ids))
        node_ids = torch.arange(nbr.shape[0], dtype=torch.int32, device=dev)
        ids, out = _descent_round_chunk(seg_corpus, nbr, seg_corpus, node_ids, nbr, sc, rnd, cfg)
        if seg_ag is None:
            return ids[None], out[None]
        return all_gather_cat(mesh, ids[None], seg_ag), all_gather_cat(mesh, out[None], seg_ag)

    return run


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


def _search_segments(seg_index, queries, spec, keywords, entities, params):
    """Every segment of a stacked index searched, results in global ids:
    (S, B, k) ids, scores, (S, B, k, 3) path scores, and the total
    expansions. One flattened pass; under the KG one pass per segment."""
    if params.use_kg:  # per-segment entity tables: one segment at a time
        parts = [
            _segment_to_global(seg_index.segment(s), seg_index.global_ids[s], queries, spec,
                               keywords, entities, params)
            for s in range(seg_index.n_segments)
        ]
        g_all, s_all, ps_all = (torch.stack([p[i] for p in parts]) for i in range(3))
        return g_all, s_all, ps_all, sum(p[3].sum() for p in parts)
    return _group_to_global(seg_index, queries, spec, keywords, entities, params)


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
        g_all, s_all, ps_all, total = _search_segments(
            seg_index, queries.to(dev), spec, keywords.to(dev, torch.int32),
            entities.to(dev, torch.int32), params)
        ids, top, ps = merge_rows_fused(g_all, s_all, ps_all, spec, params.k)
        scores = torch.where(torch.isfinite(top), top, NEG_FILL)
        expanded = total.to(torch.int32).expand(ids.shape[0]).contiguous()
        return SearchResult(ids, scores, expanded, ps)

    return run


def _spec_rows(spec: FusionSpec, rows: slice) -> FusionSpec:
    """Rows of a batched spec."""
    return FusionSpec(mode=spec.mode[rows], weights=PathWeights(
        *(getattr(spec.weights, f)[rows] for f in ("dense", "sparse", "full", "kg"))),
        rrf_k=spec.rrf_k[rows], stats=PathStats(
            *(getattr(spec.stats, f)[rows] for f in ("minv", "maxv", "mean", "std"))))


def make_distributed_search_padded(mesh, params: SearchParams):
    """The search callable over a mesh (collective), shape-stable form.

    Returns fn(seg_block, queries, fusion, keywords, entities) ->
    SearchResult with globally merged ids on every rank. ``seg_block`` is
    the rank's block (``place_segmented_index``); the other arguments are
    the whole batch, the same on every rank: each rank takes its rows on
    the model axis (the batch must divide over it), searches its segments
    in one flattened pass, all-gathers the (spd, B/m, k) results over the
    segment axes, merges all S segments in one fusion-aware pass (RRF rows
    re-rank over the union, §11), all-gathers the merged rows over the
    model axis and sums ``expanded`` over the mesh. fp32 and int8 blocks
    alike."""
    seg_ag = axis_group(mesh, SEGMENT_AXES)
    q_ag = axis_group(mesh, (QUERY_AXIS,))

    def run(
        seg_block: SegmentedIndex,
        queries: FusedVectors,
        fusion: Union[FusionSpec, PathWeights],
        keywords: torch.Tensor,
        entities: torch.Tensor,
    ) -> SearchResult:
        if isinstance(fusion, PathWeights):
            fusion = FusionSpec.from_weights(fusion)
        dev, b = seg_block.global_ids.device, queries.n
        m, qi = (q_ag.size, q_ag.index) if q_ag is not None else (1, 0)
        if b % m:
            raise ValueError(f"a batch of {b} rows does not divide over the {m} model ranks")
        rows = slice(qi * (b // m), (qi + 1) * (b // m))
        spec = _spec_rows(broadcast_spec(fusion, b, dev), rows)
        g, s, ps, total = _search_segments(
            seg_block, queries[rows].to(dev), spec,
            torch.as_tensor(keywords)[rows].to(dev, torch.int32),
            torch.as_tensor(entities)[rows].to(dev, torch.int32), params)
        if seg_ag is not None:  # all S segments' rows, in segment order
            g, s, ps = (all_gather_cat(mesh, x, seg_ag) for x in (g, s, ps))
        ids, top, ps_m = merge_rows_fused(g, s, ps, spec, params.k)
        if q_ag is not None:  # the whole batch, in row order
            ids, top, ps_m = (all_gather_cat(mesh, x, q_ag) for x in (ids, top, ps_m))
        total = torch.as_tensor(total, device=dev).to(torch.int64).reshape(1)
        if seg_ag is not None or q_ag is not None:
            total = all_reduce_sum(mesh, total)
        scores = torch.where(torch.isfinite(top), top, NEG_FILL)
        return SearchResult(ids, scores, total.to(torch.int32).expand(b).contiguous(), ps_m)

    return run


def make_distributed_search(mesh, fusion: Union[FusionSpec, PathWeights], params: SearchParams):
    """Fixed-fusion convenience wrapper over the shape-stable form: fn(seg_block,
    queries) -> SearchResult with globally merged ids (collective)."""
    run = make_distributed_search_padded(mesh, params)

    def fn(seg_block: SegmentedIndex, queries: FusedVectors) -> SearchResult:
        pad = torch.full((queries.n, 1), PAD_IDX, dtype=torch.int32)
        return run(seg_block, queries, fusion, pad, pad)

    return fn
