"""Dynamic fusion framework (DESIGN.md §11). Port of ``repro/core/fusion.py``,
the per-query adaptive selector (``adaptive_fusion``) included.

A ``FusionSpec`` carries the fusion mode, the per-path weights, the RRF
constant and the per-path normalization stats. Four modes:

  * ``weighted_sum`` (0) — the fused score IS the traversal score (Theorem 1).
  * ``minmax`` (1) — per-path scores rescaled by min/max stats, weighted-summed.
  * ``zscore`` (2) — per-path scores standardized by mean/std, weighted-summed.
  * ``rrf`` (3) — fused(i) = sum_p w_p / (k_rrf + 1 + rank_p(i)).

Traversal always navigates with the weighted-sum score; modes 1-3 re-score
the final candidate pool from per-path raw scores. All four branches are
computed and selected elementwise, as ``repro`` does with ``jnp.select``.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.usms import PAD_IDX, PathWeights
from repro_torch.kernels.ref import topk_desc

WEIGHTED_SUM = 0
MINMAX = 1
ZSCORE = 2
RRF = 3

FUSION_MODES = {"weighted_sum": WEIGHTED_SUM, "minmax": MINMAX, "zscore": ZSCORE, "rrf": RRF}
FUSION_MODE_NAMES = {v: k for k, v in FUSION_MODES.items()}

DEFAULT_RRF_K = 60.0
N_SCORE_PATHS = 3  # dense / learned-sparse / lexical (kg is a traversal bias)
_EPS = 1e-6
_NEG_FILL = np.float32(-1e30)
_NORM_CHUNK = 65536  # rows per dense-norm chunk (bounds the fp32 copy of int8 rows)


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _dense_norms(corpus) -> np.ndarray:
    """Per-row L2 norm of the dense rows, on the corpus's device in chunks,
    returned as a host float32 array. Quantized rows: ||scale * int8 row||,
    without densifying the whole corpus."""
    quant = hasattr(corpus, "dense_scale")
    dense = corpus.dense_q if quant else corpus.dense
    dense = dense.reshape(-1, dense.shape[-1])
    scale = corpus.dense_scale.reshape(-1, 1) if quant else None
    out = []
    for s in range(0, dense.shape[0], _NORM_CHUNK):
        rows = dense[s:s + _NORM_CHUNK].to(torch.float32)
        if quant:
            rows = rows * scale[s:s + _NORM_CHUNK]
        out.append(torch.linalg.vector_norm(rows, dim=-1))
    if not out:
        return np.zeros((0,), np.float32)
    return _np(torch.cat(out)).astype(np.float32)


@dataclasses.dataclass
class PathStats:
    """Per-path normalization stats, (3,) or (B, 3) float32 in
    [dense, learned, lexical] order."""

    minv: torch.Tensor
    maxv: torch.Tensor
    mean: torch.Tensor
    std: torch.Tensor

    @classmethod
    def identity(cls) -> "PathStats":
        z = torch.zeros((N_SCORE_PATHS,), dtype=torch.float32)
        o = torch.ones((N_SCORE_PATHS,), dtype=torch.float32)
        return cls(minv=z, maxv=o, mean=z.clone(), std=o.clone())

    @classmethod
    def from_corpus_parts(cls, parts) -> "PathStats":
        """Stats over one or more (corpus, alive mask | None) pairs: per-path
        L2 norms of the live rows proxy the per-path score scale. Leaves may
        carry extra leading axes (stacked segments); they are flattened. The
        dense norms come from the device; the sparse norms are taken on the
        host with numpy in the stored dtype (fp16 for quantized storage), as
        ``repro`` takes them."""
        norms = [[] for _ in range(N_SCORE_PATHS)]
        for corpus, alive in parts:
            dense = _dense_norms(corpus)
            lv = _np(corpus.learned.val)
            lv = lv.reshape(-1, lv.shape[-1])
            fv = _np(corpus.lexical.val)
            fv = fv.reshape(-1, fv.shape[-1])
            mask = np.ones(dense.shape[0], bool) if alive is None else _np(alive).reshape(-1)
            if not mask.any():
                continue
            norms[0].append(dense[mask])
            norms[1].append(np.linalg.norm(lv[mask], axis=-1))
            norms[2].append(np.linalg.norm(fv[mask], axis=-1))
        if not norms[0]:
            return cls.identity()
        f = lambda fn: torch.as_tensor(
            np.asarray([fn(np.concatenate(n)) for n in norms], np.float32))
        return cls(minv=f(np.min), maxv=f(np.max), mean=f(np.mean), std=f(np.std))

    @classmethod
    def from_corpus(cls, corpus, alive=None) -> "PathStats":
        return cls.from_corpus_parts([(corpus, alive)])

    @classmethod
    def ema(cls, old: "PathStats", new: "PathStats", alpha: float) -> "PathStats":
        """Running blend across snapshot publishes: ``alpha`` weights the
        FRESH stats. Extremes widen monotonically (min of mins, max of
        maxes), so minmax stays in range for rows both snapshots held."""
        mix = lambda o, n: (1.0 - alpha) * o + alpha * n
        return cls(
            minv=torch.minimum(old.minv, new.minv),
            maxv=torch.maximum(old.maxv, new.maxv),
            mean=mix(old.mean, new.mean),
            std=mix(old.std, new.std),
        )

    @classmethod
    def merge(cls, parts: Sequence["PathStats"], counts: Sequence[int]) -> "PathStats":
        """Combine per-shard stats into one: count-weighted moment pooling
        for mean/std, extreme-of-extremes for min/max."""
        if not parts:
            return cls.identity()
        c = np.maximum(np.asarray(counts, np.float64), 1.0)
        w = c / c.sum()
        means = np.stack([_np(p.mean).astype(np.float64) for p in parts])
        varis = np.stack([_np(p.std).astype(np.float64) ** 2 for p in parts])
        mean = (w[:, None] * means).sum(0)
        var = (w[:, None] * (varis + means**2)).sum(0) - mean**2
        t = lambda a: torch.as_tensor(np.asarray(a, np.float32))
        return cls(
            minv=t(np.min([_np(p.minv) for p in parts], axis=0)),
            maxv=t(np.max([_np(p.maxv) for p in parts], axis=0)),
            mean=t(mean),
            std=t(np.sqrt(np.maximum(var, 0.0))),
        )


@dataclasses.dataclass
class FusionSpec:
    """The query-side fusion object. A batched spec has (B,) mode/weight/
    rrf_k leaves and (B, 3) stats leaves; ``stats=None`` resolves to the
    identity stats in ``broadcast_spec``."""

    mode: torch.Tensor  # int32, scalar or (B,)
    weights: PathWeights
    rrf_k: torch.Tensor  # float32, scalar or (B,)
    stats: Optional[PathStats] = None

    @classmethod
    def make(cls, mode="weighted_sum", dense=1.0, sparse=0.0, full=0.0, kg=0.0, *,
             rrf_k: float = DEFAULT_RRF_K, stats: Optional[PathStats] = None) -> "FusionSpec":
        mode_id = FUSION_MODES[mode] if isinstance(mode, str) else int(mode)
        return cls(
            mode=torch.as_tensor(mode_id, dtype=torch.int32),
            weights=PathWeights.make(dense, sparse, full, kg),
            rrf_k=_f32(rrf_k),
            stats=stats,
        )

    @classmethod
    def weighted(cls, dense=1.0, sparse=0.0, full=0.0, kg=0.0) -> "FusionSpec":
        return cls.make("weighted_sum", dense, sparse, full, kg)

    @classmethod
    def three_path(cls) -> "FusionSpec":
        return cls.weighted(1.0, 1.0, 1.0, 0.0)

    @classmethod
    def rrf(cls, dense=1.0, sparse=1.0, full=1.0, *, rrf_k: float = DEFAULT_RRF_K) -> "FusionSpec":
        return cls.make("rrf", dense, sparse, full, rrf_k=rrf_k)

    @classmethod
    def minmax(cls, dense=1.0, sparse=1.0, full=1.0,
               stats: Optional[PathStats] = None) -> "FusionSpec":
        return cls.make("minmax", dense, sparse, full, stats=stats)

    @classmethod
    def zscore(cls, dense=1.0, sparse=1.0, full=1.0,
               stats: Optional[PathStats] = None) -> "FusionSpec":
        return cls.make("zscore", dense, sparse, full, stats=stats)

    @classmethod
    def zero(cls) -> "FusionSpec":
        """All-zero weighted-sum spec for batch pad rows."""
        return cls.weighted(0.0, 0.0, 0.0, 0.0)

    @classmethod
    def from_weights(cls, w: PathWeights) -> "FusionSpec":
        """PathWeights -> weighted-sum spec (no deprecation warning)."""
        shape = torch.broadcast_shapes(
            _f32(w.dense).shape, _f32(w.sparse).shape, _f32(w.full).shape
        )
        return cls(
            mode=torch.full(shape, WEIGHTED_SUM, dtype=torch.int32),
            weights=w,
            rrf_k=torch.full(shape, DEFAULT_RRF_K, dtype=torch.float32),
            stats=None,
        )

    def score_weights(self) -> torch.Tensor:
        """The 3 score-path weights stacked on a trailing axis: (3,)/(B, 3)."""
        w = self.weights
        return torch.stack(torch.broadcast_tensors(
            _f32(w.dense).to(self.mode.device), _f32(w.sparse).to(self.mode.device),
            _f32(w.full).to(self.mode.device)), dim=-1)


def as_fusion_spec(x, *, warn: bool = True) -> FusionSpec:
    """``FusionSpec`` passes through; ``PathWeights`` converts to a
    weighted-sum spec (deprecated shim, with a DeprecationWarning)."""
    if isinstance(x, FusionSpec):
        return x
    if isinstance(x, PathWeights):
        if warn:
            warnings.warn(
                "passing PathWeights as the query-side fusion argument is deprecated: "
                "use FusionSpec (PathWeights converts to FusionSpec(mode=weighted_sum))",
                DeprecationWarning,
                stacklevel=3,
            )
        return FusionSpec.from_weights(x)
    raise TypeError(f"expected FusionSpec or (deprecated) PathWeights, got {type(x)!r}")


def stack_specs(specs: Sequence[FusionSpec]) -> FusionSpec:
    """Stack per-request specs into one batched spec ((B,) / (B, 3) leaves),
    keeping leaf dtypes (mode stays int32). Specs with unresolved (``None``)
    stats must be resolved first."""
    resolved = [s.stats is not None for s in specs]
    if any(resolved) and not all(resolved):
        raise ValueError(
            "cannot stack FusionSpecs with mixed stats resolution: resolve "
            "stats=None against the index stats (or identity) first"
        )
    st = lambda xs, dt=torch.float32: torch.stack([torch.as_tensor(x, dtype=dt) for x in xs])
    stats = None
    if all(resolved):
        stats = PathStats(*(st([getattr(s.stats, f) for s in specs])
                            for f in ("minv", "maxv", "mean", "std")))
    return FusionSpec(
        mode=st([s.mode for s in specs], torch.int32),
        weights=PathWeights(*(st([getattr(s.weights, f) for s in specs])
                              for f in ("dense", "sparse", "full", "kg"))),
        rrf_k=st([s.rrf_k for s in specs]),
        stats=stats,
    )


def broadcast_spec(spec: FusionSpec, b: int, device=None) -> FusionSpec:
    """Broadcast a scalar-leaf (or batched) spec to (B,)/(B, 3) leaves on
    ``device``; ``stats=None`` resolves to identity here."""
    stats = spec.stats if spec.stats is not None else PathStats.identity()
    v = lambda x: _f32(x).to(device).expand(b).contiguous()
    s = lambda x: _f32(x).to(device).expand(b, N_SCORE_PATHS).contiguous()
    return FusionSpec(
        mode=torch.as_tensor(spec.mode, dtype=torch.int32).to(device).expand(b).contiguous(),
        weights=PathWeights(dense=v(spec.weights.dense), sparse=v(spec.weights.sparse),
                            full=v(spec.weights.full), kg=v(spec.weights.kg)),
        rrf_k=v(spec.rrf_k),
        stats=PathStats(minv=s(stats.minv), maxv=s(stats.maxv),
                        mean=s(stats.mean), std=s(stats.std)),
    )


def ranks_desc(ps: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Per-path descending ranks (0 = best) over candidate lists.

    ps: (..., M, 3); valid: (..., M). rank_p(i) counts the valid j with a
    strictly higher score, ties broken by position (stable)."""
    m = ps.shape[-2]
    pos = torch.arange(m, device=ps.device)
    gt = ps.unsqueeze(-3) > ps.unsqueeze(-2)  # [..., i, j, p]: j strictly beats i
    tie = (ps.unsqueeze(-3) == ps.unsqueeze(-2)) & (pos[None, :, None] < pos[:, None, None])
    beats = (gt | tie) & valid[..., None, :, None]
    return beats.sum(dim=-2).to(torch.float32)


def fuse_candidates(
    base: torch.Tensor,  # (B, M) traversal weighted-sum scores, NEG on invalid
    ps: torch.Tensor,  # (B, M, 3) per-path raw scores (0 on invalid)
    valid: torch.Tensor,  # (B, M)
    spec: FusionSpec,  # batched: (B,) / (B, 3) leaves
    neg: float,
) -> torch.Tensor:
    """Mode-selected fused score of the final candidate pool, per row."""
    w3 = spec.score_weights()[:, None, :]  # (B, 1, 3)
    st = spec.stats
    col = lambda t: t[:, None, :]
    mm_scale = torch.clamp(col(st.maxv) - col(st.minv), min=_EPS)
    z_scale = torch.clamp(col(st.std), min=_EPS)
    minmax = (((ps - col(st.minv)) / mm_scale) * w3).sum(-1)
    zscore = (((ps - col(st.mean)) / z_scale) * w3).sum(-1)
    ranks = ranks_desc(ps, valid)
    rrf = (w3 / (spec.rrf_k[:, None, None] + 1.0 + ranks)).sum(-1)
    mode = spec.mode[:, None]
    fused = torch.where(mode == WEIGHTED_SUM, base,
                        torch.where(mode == MINMAX, minmax,
                                    torch.where(mode == ZSCORE, zscore, rrf)))
    return torch.where(valid, fused, torch.full_like(fused, neg))


def merge_rows_fused(
    g_all: torch.Tensor,  # (S, B, k) global ids, PAD on empty slots
    s_all: torch.Tensor,  # (S, B, k) fused scores, -inf on empty slots
    ps_all: torch.Tensor,  # (S, B, k, 3) per-path raw scores of the winners
    spec: FusionSpec,  # batched (B,)-leaf spec
    k: int,
):
    """Fusion-aware merge of stacked per-segment results. Non-RRF rows merge
    by score; RRF rows RE-RANK: per-path ranks are recomputed over the merged
    union from ``ps_all`` (merging local RRF scores by value would compare
    ranks from different pools). Returns (ids, scores, path scores)."""
    b = g_all.shape[1]
    g = g_all.movedim(0, 1).reshape(b, -1)
    s = s_all.movedim(0, 1).reshape(b, -1)
    ps = ps_all.movedim(0, 1).reshape(b, -1, N_SCORE_PATHS)
    valid = (g >= 0) & torch.isfinite(s)
    ps = torch.where(valid[..., None], ps, 0.0)
    ranks = ranks_desc(ps, valid)
    w3 = spec.score_weights()[:, None, :]
    rrf = (w3 / (spec.rrf_k[:, None, None] + 1.0 + ranks)).sum(-1)
    eff = torch.where(spec.mode[:, None] == RRF,
                      torch.where(valid, rrf, float("-inf")), s)
    top, pos = topk_desc(eff, k)
    ok = torch.isfinite(top)
    return (
        torch.where(ok, torch.gather(g, 1, pos), PAD_IDX),
        torch.where(ok, top, float("-inf")),
        torch.where(ok[..., None],
                    torch.gather(ps, 1, pos[..., None].expand(-1, -1, N_SCORE_PATHS)), 0.0),
    )


def merge_fused_host(
    ids_parts: Sequence[np.ndarray],  # each (B, k_i) global ids
    score_parts: Sequence[np.ndarray],  # each (B, k_i) fused scores
    path_parts,  # each (B, k_i, 3) per-path raw scores, or None
    spec: Optional[FusionSpec],
    k: int,
):
    """Numpy counterpart of ``merge_rows_fused`` for host-side merges (pool
    groups). Merging RRF rows without per-path scores raises (the merge
    contract, DESIGN.md §11)."""
    all_ids = np.concatenate([np.asarray(p) for p in ids_parts], axis=1)
    all_scores = np.concatenate(
        [np.where(np.asarray(i) >= 0, np.asarray(s, np.float32), -np.inf)
         for i, s in zip(ids_parts, score_parts)],
        axis=1,
    )
    b, m = all_ids.shape
    if spec is None:
        mode = np.full((b,), WEIGHTED_SUM, np.int32)
        w3 = np.ones((b, N_SCORE_PATHS), np.float32)
        rrf_k = np.full((b,), DEFAULT_RRF_K, np.float32)
    else:
        mode = np.broadcast_to(_np(spec.mode).astype(np.int32).reshape(-1), (b,))
        w3 = np.broadcast_to(_np(spec.score_weights()).astype(np.float32)
                             .reshape(-1, N_SCORE_PATHS), (b, N_SCORE_PATHS))
        rrf_k = np.broadcast_to(_np(spec.rrf_k).astype(np.float32).reshape(-1), (b,))
    rrf_rows = mode == RRF
    missing = path_parts is None or any(p is None for p in path_parts)
    if rrf_rows.any() and missing:
        raise ValueError(
            "merge contract violation: RRF results cannot be merged by raw score — "
            "per-path scores (SearchResult.path_scores) are required to recompute "
            "ranks over the union (DESIGN.md §11)"
        )
    if missing:
        all_ps = np.zeros((b, m, N_SCORE_PATHS), np.float32)
    else:
        all_ps = np.concatenate([np.asarray(p, np.float32) for p in path_parts], axis=1)
    valid = (all_ids >= 0) & np.isfinite(all_scores)
    all_ps = np.where(valid[:, :, None], all_ps, 0.0)
    if rrf_rows.any():
        pos = np.arange(m)
        gt = all_ps[:, None, :, :] > all_ps[:, :, None, :]  # [b, i, j, p]
        tie = (all_ps[:, None, :, :] == all_ps[:, :, None, :]) & (
            pos[None, None, :, None] < pos[None, :, None, None])
        beats = (gt | tie) & valid[:, None, :, None]
        ranks = beats.sum(axis=2).astype(np.float32)  # (b, m, 3)
        rrf_scores = (w3[:, None, :] / (rrf_k[:, None, None] + 1.0 + ranks)).sum(-1)
        eff = np.where(rrf_rows[:, None], np.where(valid, rrf_scores, -np.inf), all_scores)
    else:
        eff = all_scores
    order = np.argsort(-eff, axis=1, kind="stable")[:, :k]
    m_ids = np.take_along_axis(all_ids, order, axis=1)
    m_scores = np.take_along_axis(eff, order, axis=1)
    m_ps = np.take_along_axis(all_ps, order[:, :, None], axis=1)
    ok = np.isfinite(m_scores)
    return (
        np.where(ok, m_ids, PAD_IDX).astype(np.int32),
        np.where(ok, m_scores, _NEG_FILL).astype(np.float32),
        np.where(ok[:, :, None], m_ps, 0.0).astype(np.float32),
    )


# ---------------------------------------------------------------------------
# Per-query adaptive selector (the ingest/query path hook).
# ---------------------------------------------------------------------------


def query_nnz(vectors) -> np.ndarray:
    """Live lexical terms per query row — the query-specificity signal the
    adaptive selector keys on."""
    return np.asarray((_np(vectors.lexical.idx) >= 0).sum(axis=-1))


def adaptive_fusion(
    keywords,
    entities,
    nnz,
    *,
    stats: Optional[PathStats] = None,
    rrf_k: float = DEFAULT_RRF_K,
) -> FusionSpec:
    """Per-query fusion-mode selector from query characteristics (host-side
    and cheap):

      * entity-bearing queries -> weighted_sum with the KG path on (entity
        waypoints steer traversal; rank fusion would dilute the logical
        reward, which only the weighted mode folds into final scores);
      * >= 2 required keywords -> RRF (precision-shaped query: rank fusion
        is robust to the paths' incomparable score scales);
      * lexically rich queries (nnz >= 8) -> zscore-normalized weighted sum
        (many live terms make the lexical magnitude dominate raw sums);
      * else -> dense-leaning weighted sum.

    Returns a batched (B,)-leaf FusionSpec of host tensors; pass ``stats``
    (e.g. a service's running stats) to pin normalization, else it resolves
    downstream."""
    kw = _np(keywords) if keywords is not None else None
    en = _np(entities) if entities is not None else None
    nnz = _np(nnz)
    b = nnz.shape[0]
    kw_count = (kw >= 0).sum(axis=-1) if kw is not None and kw.size else np.zeros(b)
    has_ent = (en >= 0).any(axis=-1) if en is not None and en.size else np.zeros(b, bool)
    mode = np.full(b, WEIGHTED_SUM, np.int32)
    wd = np.ones(b, np.float32)
    ws = np.full(b, 0.5, np.float32)
    wf = np.full(b, 0.5, np.float32)
    wk = np.zeros(b, np.float32)

    lex_rich = nnz >= 8
    mode[lex_rich] = ZSCORE
    ws[lex_rich] = 1.0
    wf[lex_rich] = 1.0

    kw_rich = kw_count >= 2
    mode[kw_rich] = RRF
    ws[kw_rich] = 1.0
    wf[kw_rich] = 1.0

    mode[has_ent] = WEIGHTED_SUM
    wd[has_ent] = 1.0
    ws[has_ent] = 1.0
    wf[has_ent] = 1.0
    wk[has_ent] = 1.0

    batched_stats = None
    if stats is not None:
        s = lambda x: _f32(_np(x)).expand(b, N_SCORE_PATHS).contiguous()
        batched_stats = PathStats(minv=s(stats.minv), maxv=s(stats.maxv),
                                  mean=s(stats.mean), std=s(stats.std))
    t = torch.from_numpy
    return FusionSpec(
        mode=t(mode),
        weights=PathWeights(dense=t(wd), sparse=t(ws), full=t(wf), kg=t(wk)),
        rrf_k=torch.full((b,), rrf_k, dtype=torch.float32),
        stats=batched_stats,
    )
