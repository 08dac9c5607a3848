"""Dynamic fusion framework (DESIGN.md §11). Port of ``repro/core/fusion.py``
(corpus stats, ``stack_specs``, the merge helpers and the adaptive selector
wait for the serving slice).

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
from typing import Optional

import torch

from repro_torch.core.usms import PathWeights

WEIGHTED_SUM = 0
MINMAX = 1
ZSCORE = 2
RRF = 3

FUSION_MODES = {"weighted_sum": WEIGHTED_SUM, "minmax": MINMAX, "zscore": ZSCORE, "rrf": RRF}

DEFAULT_RRF_K = 60.0
N_SCORE_PATHS = 3  # dense / learned-sparse / lexical (kg is a traversal bias)
_EPS = 1e-6


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


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
