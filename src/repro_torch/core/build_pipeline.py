"""Index construction (paper §4.1, Algorithm 1). Port of
``repro/core/build_pipeline.py``.

``repro`` runs the graph stages as one jitted program (``fori_loop`` over
rounds, ``lax.map`` over node chunks, ``vmap`` over the three single-path
views). Here the same stages are Python loops over rounds and node chunks on
batched tensors; the heavy work of every chunk is one kernel launch:

  1. NN-Descent: ``fused_topk`` per chunk and round (rows gathered by id);
  1b. per-path refinement: the same descent, with each chunk's query rows
      scaled by the path weights on the fly (no weighted corpus copies);
  2-3. RNG-IP pruning + keyword recycling: ``pairwise_tile`` per chunk;
  entry points: self and per-path norms through ``hybrid_distance`` with
      ids = arange(N)[:, None];
  4. logical edges: host-side numpy.

``insert`` (paper §4.1 "Updates") runs the same stages over a batch of new
docs: a search probe of the existing index, NN-Descent among the new nodes,
the merge, self scores, one prune chunk over the new nodes, and the
back-link pass that gives old nodes edges to them.

Random draws: torch cannot reproduce ``jax.random``, so the builder takes a
``torch.Generator`` and, optionally, precomputed draws (``BuildDraws``), which
lets a test feed in the draws ``repro`` made.

Under an active ``obs.tracing`` context a build records the spans ``build``
> ``build.descent`` (> ``build.descent.init``, ``build.descent.round`` per
round), ``build.refinement`` (> ``build.refinement.path`` per path, each >
``build.refinement.init`` and ``.round``), ``build.prune`` (>
``build.prune.self_scores``, ``build.prune.chunk`` per node chunk),
``build.entry_points`` and ``build.logical_edges`` (DESIGN.md §12).
``build_index(report=...)`` reads its ``stage_seconds`` from those stage
spans, under a context of its own when none is active.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import knn_graph, pruning
from repro_torch.core.fusion import FusionSpec
from repro_torch.core.index import BuildConfig, HybridIndex
from repro_torch.core.knn_graph import KnnConfig, _merge_topk, new_node_reverse
from repro_torch.core.logical_edges import LogicalEdges, build_logical_edges
from repro_torch.core.search import SearchParams, search
from repro_torch.core.usms import PAD_IDX, FusedVectors, PathWeights, cat_fused, weighted_query
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.ref import topk_desc
from repro_torch.runtime import dispatch

SINGLE_PATH_WEIGHTS = (
    PathWeights.make(1.0, 0.0, 0.0),
    PathWeights.make(0.0, 1.0, 0.0),
    PathWeights.make(0.0, 0.0, 1.0),
)
_NORM_CHUNK = 65536  # rows per per-path norm launch (bounds the weighted copy)


@dataclasses.dataclass
class BuildDraws:
    """Random draws of one build, in place of the generator's.

    init_graph:  (N, knn.k) initial neighbor ids.
    rounds:      one (N, extra_random) id table per NN-Descent round.
    path_rounds: per single path (dense, learned, lexical), one table per
                 refinement round.
    Any field left None is drawn from the generator.
    """

    init_graph: Optional[torch.Tensor] = None
    rounds: Optional[Sequence[torch.Tensor]] = None
    path_rounds: Optional[Sequence[Sequence[torch.Tensor]]] = None


@dataclasses.dataclass
class GraphArrays:
    knn_ids: torch.Tensor  # (N, K)
    knn_scores: torch.Tensor  # (N, K)
    semantic_edges: torch.Tensor  # (N, d)
    keyword_edges: torch.Tensor  # (N, dk)
    entry_points: torch.Tensor  # (n_entry,)
    self_ip: torch.Tensor  # (N,)


def _chunks(n: int, chunk: int):
    return [(s, min(s + chunk, n)) for s in range(0, n, max(chunk, 1))]


def _rows(corpus: FusedVectors, s: int, e: int, weights: PathWeights | None) -> FusedVectors:
    """Query rows s:e, scaled by ``weights`` for a single-path view."""
    rows = corpus[s:e]
    return rows if weights is None else weighted_query(rows, weights)


def _randint(n: int, shape, gen: torch.Generator, device) -> torch.Tensor:
    return torch.randint(0, n, shape, generator=gen, device=device, dtype=torch.int32)


def _on(t: torch.Tensor, device) -> torch.Tensor:
    return torch.as_tensor(t).to(device=device, dtype=torch.int32)


# ---------------------------------------------------------------------------
# Stage 1: NN-Descent
# ---------------------------------------------------------------------------


def _descent_init(
    corpus: FusedVectors, weights: PathWeights | None, nbr_ids: torch.Tensor, cfg: KnnConfig,
    stage: str = "build.descent",
):
    """Score and sort the initial rows (k == row width: the fused top-k is
    the sort), chunk by chunk; span ``<stage>.init``."""
    k = cfg.k
    ids_out, sc_out = [], []
    with obs.span(stage + ".init"):
        for s, e in _chunks(corpus.n, cfg.node_chunk):
            top, pos = ops.fused_topk_vs_ids(
                _rows(corpus, s, e, weights), corpus, nbr_ids[s:e], k, use_kernel=cfg.use_kernel
            )
            ids = ops.take_topk_ids(nbr_ids[s:e], pos)
            ids_out.append(ids)
            sc_out.append(torch.where(ids >= 0, top, torch.full_like(top, float("-inf"))))
        return torch.cat(ids_out), torch.cat(sc_out)


def _descent_rounds(
    corpus: FusedVectors,
    weights: PathWeights | None,
    nbr_ids: torch.Tensor,
    nbr_scores: torch.Tensor,
    cfg: KnnConfig,
    rand_rounds: Sequence[torch.Tensor],
    stage: str = "build.descent",
):
    """One NN-Descent round per table in ``rand_rounds``; each streams node
    chunks against the round-start neighbor table. Span ``<stage>.round``
    per round."""
    n = corpus.n
    node_ids = torch.arange(n, dtype=torch.int32, device=nbr_ids.device)
    round_span = stage + ".round"
    for r, rand_ids in enumerate(rand_rounds):
        with obs.span(round_span, i=r):
            ids_out, sc_out = [], []
            for s, e in _chunks(n, cfg.node_chunk):
                ids_c, sc_c = knn_graph._descent_round_chunk(
                    corpus, nbr_ids, _rows(corpus, s, e, weights), node_ids[s:e],
                    nbr_ids[s:e], nbr_scores[s:e], rand_ids[s:e], cfg,
                )
                ids_out.append(ids_c)
                sc_out.append(sc_c)
            nbr_ids, nbr_scores = torch.cat(ids_out), torch.cat(sc_out)
    return nbr_ids, nbr_scores


def nn_descent(
    corpus: FusedVectors,
    cfg: KnnConfig,
    generator: torch.Generator,
    *,
    init_graph: torch.Tensor | None = None,
    rounds: Sequence[torch.Tensor] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused NN-Descent over the corpus. Returns (nbr_ids (N, K), scores
    (N, K)) sorted by hybrid score, descending per row. Counts as two
    dispatches (the init and the round loop), as ``repro``'s does."""
    dispatch.tick()
    dispatch.tick()
    return _nn_descent(corpus, cfg, generator, init_graph=init_graph, rounds=rounds)


def _nn_descent(corpus, cfg, generator, *, init_graph=None, rounds=None):
    n, dev = corpus.n, corpus.device
    init = _on(init_graph, dev) if init_graph is not None else knn_graph._init_graph(
        n, cfg.k, generator, dev)
    ids, scores = _descent_init(corpus, None, init, cfg)
    if rounds is None:
        rounds = [_randint(n, (n, cfg.extra_random), generator, dev) for _ in range(cfg.iters)]
    return _descent_rounds(corpus, None, ids, scores, cfg, [_on(r, dev) for r in rounds])


# ---------------------------------------------------------------------------
# Stage 1b: per-path refinement
# ---------------------------------------------------------------------------


def _graph_pk(cfg: BuildConfig) -> int:
    d = cfg.prune.degree
    return max((d - 2 * max(d // 4, 1)) // 3 + 1, 2)


def _path_refinement(
    corpus: FusedVectors,
    knn_ids: torch.Tensor,
    cfg: BuildConfig,
    pk: int,
    generator: torch.Generator,
    draws: BuildDraws,
) -> torch.Tensor:
    """The d/2 single-path neighbor slots: a short descent per path, warm
    started from the fused graph, with each chunk's query rows scaled by
    the path weights. Returns (N, 3, pk) per-path neighbor ids."""
    n, dev = corpus.n, corpus.device
    pcfg = dataclasses.replace(cfg.knn, iters=cfg.path_refine_iters, k=max(pk, 12))
    per_path = []
    for p, w in enumerate(SINGLE_PATH_WEIGHTS):
        with obs.span("build.refinement.path", path=p):
            nbr = knn_ids[:, : pcfg.k]
            if nbr.shape[1] < pcfg.k:  # knn.k < 12: widen with random ids
                extra = knn_graph._init_graph(n, pcfg.k - nbr.shape[1], generator, dev)
                nbr = torch.cat([nbr, extra], dim=1)
            if draws.path_rounds is not None:
                rounds = [_on(r, dev) for r in draws.path_rounds[p]]
            else:
                rounds = [_randint(n, (n, pcfg.extra_random), generator, dev)
                          for _ in range(pcfg.iters)]
            ids, scores = _descent_init(corpus, w, nbr.contiguous(), pcfg, "build.refinement")
            ids, _ = _descent_rounds(corpus, w, ids, scores, pcfg, rounds, "build.refinement")
            per_path.append(ids[:, :pk])
    return torch.stack(per_path, dim=1)


# ---------------------------------------------------------------------------
# Entry points (paper §4.2.1)
# ---------------------------------------------------------------------------


def _path_norms(corpus: FusedVectors, w: PathWeights, use_kernel) -> torch.Tensor:
    """score(w ⊙ v, v) for every row: the distance kernel with
    ids = arange(N)[:, None], query rows weighted chunk by chunk."""
    out = []
    for s, e in _chunks(corpus.n, _NORM_CHUNK):
        ids = torch.arange(s, e, dtype=torch.int32, device=corpus.device)[:, None]
        out.append(ops.hybrid_scores_vs_ids(
            _rows(corpus, s, e, w), corpus, ids, use_kernel=use_kernel)[:, 0])
    return torch.cat(out)


def _entry_points(
    corpus: FusedVectors, sip: torch.Tensor, n_entry: int, use_kernel: bool | None
) -> torch.Tensor:
    """Union of top-norm nodes under the fused metric AND each single path."""
    per = max(-(-n_entry // 4), 1)
    parts = [topk_desc(sip, per)[1]]
    for w in SINGLE_PATH_WEIGHTS:
        parts.append(topk_desc(_path_norms(corpus, w, use_kernel), per)[1])
    cat = torch.cat(parts).to(torch.int32)
    entries = pruning.unique_take(cat, torch.zeros(cat.shape, device=cat.device), n_entry)
    fill = topk_desc(sip, n_entry)[1].to(torch.int32)  # backfill duplicates
    return torch.where(entries >= 0, entries, fill)


# ---------------------------------------------------------------------------
# Assembly
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _stage(name: str, sync_on):
    """One build stage as a span, ended by a sync of ``sync_on`` (a CUDA
    device, or None for no sync) so that the span holds its device work."""
    with obs.span(name):
        yield
        if sync_on is not None:
            torch.cuda.synchronize(sync_on)


def build_graph(
    corpus: FusedVectors,
    cfg: BuildConfig,
    generator: torch.Generator,
    *,
    draws: BuildDraws | None = None,
    sync_stages: bool = False,
) -> GraphArrays:
    """All graph stages (Algorithm 1 steps 1-3 + entry points): one
    dispatch, ``corpus.n`` build rows. ``sync_stages`` ends each stage with
    a device sync, so its span's seconds hold its device work."""
    dispatch.tick()
    dispatch.build_rows_tick(corpus.n)
    draws = draws or BuildDraws()
    sync_on = corpus.device if sync_stages and corpus.device.type == "cuda" else None
    with _stage("build.descent", sync_on):
        knn_ids, knn_scores = _nn_descent(
            corpus, cfg.knn, generator, init_graph=draws.init_graph, rounds=draws.rounds
        )
    path_ids = None
    with _stage("build.refinement", sync_on):
        if cfg.path_refine_iters > 0:
            path_ids = _path_refinement(corpus, knn_ids, cfg, _graph_pk(cfg), generator, draws)
    with _stage("build.prune", sync_on):
        with obs.span("build.prune.self_scores"):
            cself = pruning.self_scores(corpus, use_kernel=cfg.prune.use_kernel)
        sem, kw = pruning.prune_all(corpus, knn_ids, knn_scores, cself, path_ids, cfg.prune)
    with _stage("build.entry_points", sync_on):
        entries = _entry_points(corpus, cself, min(cfg.n_entry, corpus.n), cfg.prune.use_kernel)
    return GraphArrays(knn_ids, knn_scores, sem, kw, entries, cself)


def build_index(
    corpus: FusedVectors,
    cfg: BuildConfig = BuildConfig(),
    *,
    generator: Optional[torch.Generator] = None,
    draws: Optional[BuildDraws] = None,
    kg_triplets: Optional[np.ndarray] = None,
    doc_entities: Optional[np.ndarray] = None,
    n_entities: int = 0,
    device=None,
    report: Optional[dict] = None,
) -> HybridIndex:
    """Full construction (Algorithm 1) on ``device`` (``None`` -> CUDA;
    raises when CUDA is absent). ``generator`` defaults to seed 0 on the
    device. ``report`` (a dict), when given, receives ``stage_seconds``
    (the seconds of each stage span, each graph stage ended by a device
    sync) and ``knn_ids`` (the NN-Descent graph the edges were pruned
    from)."""
    dev = resolve_device(device)
    corpus = corpus.to(dev)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    n = corpus.n
    # the stage seconds are the stage spans': with no context active, the
    # build records them into one of its own
    own = obs.TraceContext("build") if report is not None and obs.active() is None else None
    with obs.tracing(own), obs.span("build", n=n) as span:
        g = build_graph(corpus, cfg, generator, draws=draws, sync_stages=report is not None)
        # Step 4: logical edges (host-side numpy)
        with obs.span("build.logical_edges"):
            if kg_triplets is not None and doc_entities is not None and n_entities > 0:
                log = build_logical_edges(
                    kg_triplets, np.asarray(doc_entities), n_entities,
                    l_cap=cfg.logical_cap, m_cap=cfg.entity_doc_cap,
                )
            else:
                log = LogicalEdges.empty(n)
    if report is not None:
        report["stage_seconds"] = {c.name.removeprefix("build."): c.duration
                                   for c in span.children}
        report["knn_ids"] = g.knn_ids

    t = lambda a: torch.as_tensor(a).to(dev)
    return HybridIndex(
        corpus=corpus,
        semantic_edges=g.semantic_edges,
        keyword_edges=g.keyword_edges,
        logical_edges=t(log.edges),
        doc_entities=t(log.doc_entities),
        entity_to_docs=t(log.entity_to_docs),
        entity_adj=t(log.entity_adj),
        entry_points=g.entry_points,
        alive=torch.ones((n,), dtype=torch.bool, device=dev),
        self_ip=g.self_ip,
    )



# ---------------------------------------------------------------------------
# Insert (paper §4.1 "Updates")
# ---------------------------------------------------------------------------


def _last_wins(rows: torch.Tensor, n: int) -> torch.Tensor:
    """Per target row, the position of the LAST write to it in ``rows``
    (-1 where none): duplicate targets resolve in row order on every device,
    as XLA's CPU scatter applies them (``index_put_`` with duplicate indices
    is nondeterministic on CUDA)."""
    pos = torch.arange(rows.shape[0], device=rows.device)
    win = torch.full((n,), -1, dtype=pos.dtype, device=rows.device)
    return win.scatter_reduce(0, rows.long(), pos, reduce="amax")


def _back_link(sem_old: torch.Tensor, merged_ids: torch.Tensor, n_old: int, k: int):
    """Each new node replaces the weakest semantic edge of its strongest old
    neighbors (the first min(4, k) columns of its merged list) with itself.
    Writes into a copy, never the published table. Invalid targets (PAD or
    new nodes) are clipped onto row 0 or n_old - 1 and write back the value
    they read, as ``repro`` does, so they can clobber a real back-link of
    the same pass (ROADMAP Queue 3)."""
    sem = sem_old.clone()
    n_new = merged_ids.shape[0]
    new_id = torch.arange(n_new, dtype=torch.int32, device=sem.device) + n_old
    for j in range(min(4, k)):
        tgt = merged_ids[:, j]
        ok = (tgt >= 0) & (tgt < n_old)
        tgt_safe = tgt.clamp(0, n_old - 1).long()
        col = sem.shape[1] - 1 - (j % 2)  # weakest slots: edge lists are priority-ordered
        vals = torch.where(ok, new_id, sem[tgt_safe, col])
        win = _last_wins(tgt_safe, n_old)
        hit = torch.nonzero(win >= 0).squeeze(1)
        sem[hit, col] = vals[win[hit]]
    return sem


def _insert_program(
    corpus_cat: FusedVectors,  # (n_old + n_new, ...) concatenated corpus
    new_docs: FusedVectors,  # (n_new, ...)
    old_self_ip: torch.Tensor,  # (n_old,)
    sem_old: torch.Tensor,  # (n_old, d)
    old_ids: torch.Tensor,  # (n_new, k) search results vs the existing index
    old_scores: torch.Tensor,  # (n_new, k)
    new_ids_local: torch.Tensor,  # (n_new, k) NN-Descent among the new nodes
    new_scores: torch.Tensor,  # (n_new, k)
    cfg: BuildConfig,
):
    """Merge + self scores + reverse + prune + back-link for an insert batch
    (``repro``'s fused program of the same name). Returns (semantic edges of
    the old rows with back-links, the new rows' semantic and keyword edges,
    self scores of all rows)."""
    n_old, n_new, k = sem_old.shape[0], new_docs.n, cfg.knn.k
    dev = sem_old.device
    new_ids_global = torch.where(new_ids_local >= 0, new_ids_local + n_old,
                                 torch.full_like(new_ids_local, PAD_IDX))
    merged_ids, merged_scores = _merge_topk(old_ids, old_scores, new_ids_global, new_scores, k)
    cself = torch.cat([old_self_ip,
                       pruning.self_scores(new_docs, use_kernel=cfg.prune.use_kernel)])
    # reverse edges among the new nodes only: merged_ids holds GLOBAL ids
    rev = new_node_reverse(merged_ids, n_old, max(cfg.prune.degree // 4, 1))
    node_ids = torch.arange(n_new, dtype=torch.int32, device=dev) + n_old
    sem_new, kw_new, _ = pruning._prune_chunk(
        corpus_cat, new_docs, node_ids, merged_ids, merged_scores, cself, rev, None, cfg.prune)
    return _back_link(sem_old, merged_ids, n_old, k), sem_new, kw_new, cself


def insert(
    index: HybridIndex,
    new_docs: FusedVectors,
    cfg: BuildConfig,
    *,
    generator: Optional[torch.Generator] = None,
    draws: Optional[BuildDraws] = None,
    new_doc_entities: Optional[np.ndarray] = None,
    search_params: Optional[SearchParams] = None,
) -> HybridIndex:
    """Insert new nodes on the index's device: their k-NN is the merge of (a)
    a search of the existing index and (b) NN-Descent among the new nodes
    (``draws.init_graph`` / ``draws.rounds`` in place of the generator's);
    then one prune chunk over the new nodes and the back-link pass. Returns
    a new index; the given one is never written.

    ``search_params`` bounds the step-(a) probe; ``k`` and the edge paths
    are forced to the build's values (``use_keywords=False``,
    ``use_kg=False``, ``pool_size >= 2k``), so the merge widths stay fixed
    whatever the caller's serving params."""
    dev = index.semantic_edges.device
    new_docs = new_docs.to(dev)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(1)
    draws = draws or BuildDraws()
    n_new, k = new_docs.n, cfg.knn.k
    dispatch.build_rows_tick(n_new)

    # (a) k-NN from the existing index through its own search
    if search_params is None:
        params = SearchParams(k=k, iters=max(24, 2 * k), use_kernel=cfg.knn.use_kernel)
    else:
        params = dataclasses.replace(
            search_params, k=k, use_keywords=False, use_kg=False,
            use_kernel=cfg.knn.use_kernel, pool_size=max(search_params.pool_size, 2 * k))
    dispatch.tick()
    res = search(index, new_docs, FusionSpec.from_weights(PathWeights.three_path()), params,
                 device=dev)

    # (b) NN-Descent among the new nodes only
    new_ids_local, new_scores = nn_descent(
        new_docs, cfg.knn, generator, init_graph=draws.init_graph, rounds=draws.rounds)

    corpus = cat_fused([index.corpus, new_docs])

    dispatch.tick()
    sem_old, sem_new, kw_new, cself = _insert_program(
        corpus, new_docs, index.self_ip, index.semantic_edges, res.ids, res.scores,
        new_ids_local, new_scores, cfg)

    def pad_rows(a):
        return torch.cat([a, torch.full((n_new,) + tuple(a.shape[1:]), PAD_IDX, dtype=a.dtype,
                                        device=dev)])

    if new_doc_entities is not None:
        ents = torch.as_tensor(np.asarray(new_doc_entities, np.int32), device=dev)
        if ents.shape[1] != index.doc_entities.shape[1]:
            raise ValueError("entity width mismatch")
        doc_entities = torch.cat([index.doc_entities, ents])
    else:
        doc_entities = pad_rows(index.doc_entities)

    return HybridIndex(
        corpus=corpus,
        semantic_edges=torch.cat([sem_old, sem_new]),
        keyword_edges=torch.cat([index.keyword_edges, kw_new]),
        logical_edges=pad_rows(index.logical_edges),
        doc_entities=doc_entities,
        entity_to_docs=index.entity_to_docs,
        entity_adj=index.entity_adj,
        entry_points=index.entry_points,
        alive=torch.cat([index.alive, torch.ones((n_new,), dtype=torch.bool, device=dev)]),
        self_ip=cself,
    )


# ---------------------------------------------------------------------------
# Row-axis reshaping of a built index (shape bucketing): the segment pool's
# capacity-padded segments.
# ---------------------------------------------------------------------------


def map_index_rows(index: HybridIndex, fn) -> HybridIndex:
    """Apply ``fn(tensor, pad_fill)`` to every per-row (axis 0 == N) tensor of
    a single-segment fp32 index; entity tables and entry points are
    N-independent."""
    from repro_torch.core.usms import PAD_IDX, SparseVec

    c = index.corpus
    return dataclasses.replace(
        index,
        corpus=FusedVectors(
            fn(c.dense, 0),
            SparseVec(fn(c.learned.idx, PAD_IDX), fn(c.learned.val, 0)),
            SparseVec(fn(c.lexical.idx, PAD_IDX), fn(c.lexical.val, 0)),
        ),
        semantic_edges=fn(index.semantic_edges, PAD_IDX),
        keyword_edges=fn(index.keyword_edges, PAD_IDX),
        logical_edges=fn(index.logical_edges, PAD_IDX),
        doc_entities=fn(index.doc_entities, PAD_IDX),
        alive=fn(index.alive, False),
        self_ip=fn(index.self_ip, 0.0),
    )


def pad_index_rows(index: HybridIndex, capacity: int) -> HybridIndex:
    """Pad an index's per-row tensors with DEAD rows up to ``capacity``. Pad
    rows are unreachable: entry points and edges reference only real rows,
    ``alive`` is False, and no global-id map covers them."""
    n = index.n
    if capacity <= n:
        return index

    def pad(a, fill):
        tail = torch.full((capacity - n,) + tuple(a.shape[1:]), fill, dtype=a.dtype,
                          device=a.device)
        return torch.cat([a, tail])

    return map_index_rows(index, pad)


def slice_index_rows(index: HybridIndex, n: int) -> HybridIndex:
    """Drop a padded index's dead tail (inverse of ``pad_index_rows``)."""
    if index.n == n:
        return index
    return map_index_rows(index, lambda a, _fill: a[:n])
