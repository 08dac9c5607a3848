"""BM25 / TF-IDF term weighting emitted directly as fixed-nnz ELL vectors.
Port of ``repro/ingest/weighting.py``: the weights and the packed ELL
arrays are host numpy, computed in the same float order as ``repro``'s, so
they are bit-identical; ``to_ell`` wraps them as a ``SparseVec`` of tensors
only at the end, on the caller's device.

Corpus statistics (document frequency per hashed id, average document
length) are computed in ONE pass over the fitted corpus and then frozen —
the streaming-insert contract: documents ingested later are weighted with
the *fitted* statistics, so already-indexed vectors never change value and
sealed-segment executables (keyed on shapes, fed by values) stay warm.
"Balancing the Blend" (arXiv:2508.01405) is the motivation for carrying an
honest lexical weighting next to the dense path rather than a 0/1 term mask.

Output layout matches ``repro_torch.core.usms.SparseVec`` exactly: top-P terms per row
by weight, ids unique per row (hash collisions merged upstream), PAD_IDX in
unused id slots, 0.0 in unused value slots.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable

import numpy as np
import torch

from repro_torch.core.usms import PAD_IDX, SparseVec
from repro_torch.device import resolve_device


@dataclasses.dataclass
class CorpusStats:
    """Frozen one-pass corpus statistics for both hashed id spaces."""

    n_docs: int
    avg_dl: float  # average analyzed-token count per document
    df_learned: np.ndarray  # (vocab_size,) int32 document frequency
    df_lexical: np.ndarray  # (lexical_vocab_size,) int32

    @classmethod
    def from_docs(
        cls,
        learned_counts: Iterable[dict[int, int]],
        lexical_counts: Iterable[dict[int, int]],
        doc_lengths: Iterable[int],
        vocab_size: int,
        lexical_vocab_size: int,
    ) -> "CorpusStats":
        df_l = np.zeros(vocab_size, np.int32)
        df_f = np.zeros(lexical_vocab_size, np.int32)
        n = 0
        total_dl = 0
        for lc, fc, dl in zip(learned_counts, lexical_counts, doc_lengths):
            for i in lc:
                df_l[i] += 1
            for i in fc:
                df_f[i] += 1
            n += 1
            total_dl += dl
        return cls(
            n_docs=n,
            avg_dl=total_dl / max(n, 1),
            df_learned=df_l,
            df_lexical=df_f,
        )


def tfidf_weights(counts: dict[int, int], stats: CorpusStats) -> dict[int, float]:
    """Sublinear TF * smoothed IDF over the learned hashed vocab (the
    SPLADE-analogue magnitude profile: frequent terms -> small weights)."""
    n = max(stats.n_docs, 1)
    out = {}
    for i, tf in counts.items():
        idf = math.log((1.0 + n) / (1.0 + float(stats.df_learned[i]))) + 1.0
        out[i] = (1.0 + math.log(tf)) * idf
    return out


def bm25_weights(
    counts: dict[int, int],
    dl: int,
    stats: CorpusStats,
    k1: float = 1.2,
    b: float = 0.75,
) -> dict[int, float]:
    """Okapi BM25 over the lexical hashed vocab. ``dl`` is the document's
    analyzed length; df/avg_dl come from the FROZEN stats."""
    n = max(stats.n_docs, 1)
    norm = k1 * (1.0 - b + b * dl / max(stats.avg_dl, 1e-9))
    out = {}
    for i, tf in counts.items():
        df = float(stats.df_lexical[i])
        idf = math.log(1.0 + (n - df + 0.5) / (df + 0.5))
        out[i] = max(idf, 1e-6) * tf * (k1 + 1.0) / (tf + norm)
    return out


def to_ell(
    rows: list[dict[int, float]], cap: int, normalize: bool = True, *, device=None
) -> SparseVec:
    """Pack per-row {id: weight} dicts into a fixed-nnz ELL ``SparseVec`` on
    ``device`` (``None`` -> CUDA): top-``cap`` ids by weight, PAD_IDX/0.0 in
    unused slots, ids unique per row (guaranteed by the dict). The arrays
    are packed on the host, as ``repro`` packs them. ``normalize``
    L2-scales each row so the three USMS paths contribute on comparable
    magnitudes and the query-time path weights mean what they say (the
    blend-balancing concern of arXiv:2508.01405 — raw BM25 magnitudes would
    drown a unit-norm dense path ~10x)."""
    n = len(rows)
    idx = np.full((n, cap), PAD_IDX, np.int32)
    val = np.zeros((n, cap), np.float32)
    for r, weights in enumerate(rows):
        if not weights:
            continue
        items = sorted(weights.items(), key=lambda kv: (-kv[1], kv[0]))[:cap]
        for c, (i, w) in enumerate(items):
            if w <= 0.0:
                break
            idx[r, c] = i
            val[r, c] = w
    if normalize:
        norms = np.maximum(np.linalg.norm(val, axis=-1, keepdims=True), 1e-9)
        val = (val / norms).astype(np.float32)
    dev = resolve_device(device)
    return SparseVec(torch.from_numpy(idx).to(dev), torch.from_numpy(val).to(dev))


def hashed_dense_embedding(
    rows: list[dict[int, float]],
    projection: np.ndarray,  # (vocab_size, d) float32
) -> np.ndarray:
    """Deterministic dense embedding: weighted sum of per-term random
    projections, unit-normalized — the offline-friendly stand-in for a
    neural embedder (collisions and the low dimension supply realistic
    semantic blur; exact term evidence lives in the sparse paths)."""
    d = projection.shape[1]
    out = np.zeros((len(rows), d), np.float32)
    for r, weights in enumerate(rows):
        for i, w in weights.items():
            out[r] += w * projection[i]
    norms = np.maximum(np.linalg.norm(out, axis=-1, keepdims=True), 1e-9)
    return (out / norms).astype(np.float32)


def make_projection(vocab_size: int, d: int, seed: int) -> np.ndarray:
    """The (vocab_size, d) token projection table, reproducible from its
    seed (persistence stores the seed, never the 8MB table)."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((vocab_size, d)) / np.sqrt(d)).astype(np.float32)
