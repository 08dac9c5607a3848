"""Index persistence: a ``HybridIndex`` or ``SegmentPool`` that survives a
restart. Port of ``repro/checkpoint/index_io.py``.

Uses ``checkpoint.checkpoint``'s atomic manifest + leaf layout (temporary
directory -> rename -> ``.done`` commit marker):

    <dir>/step_<N>/      manifest.json + leaf_<i>.npy (N grows per save,
                         retention keeps 1)
    <dir>/step_<N>.done  commit marker
    <dir>/ingest_step_<N>/  ingest_manifest.json + ingest_arrays.npz (the
                         fitted ingest pipeline paired with step N, when
                         given)

``repro`` orders the leaves by ``jax.tree_util``'s flatten of its registered
dataclasses. Here the same order, the same manifest ``paths`` and the same
treedef string come from explicit field lists, so an index or pool saved
by either package loads into the other, and the two packages write equal
manifests and byte-equal leaf files for the same index. The manifest
carries the quantization record and, for a pool, the per-group storage
dtypes (``pool_groups``), which are the load-time group template; a legacy
manifest without them loads as uniform fp32 groups.

A checkpoint paired with a fitted ``ingest.IngestPipeline`` (``ingest=``)
writes the pipeline's manifest to ``ingest_step_<N>`` BEFORE index step N
commits, and ``load_ingest`` reads the manifest of the latest committed
step, so a crash anywhere never pairs a new index with stale stats (or the
reverse). The ingest manifest and arrays are ``repro``'s too.
"""

from __future__ import annotations

import json
import os
import pathlib
import shutil
from typing import Optional

import numpy as np

from repro_torch.checkpoint.checkpoint import all_steps, load_leaf, save_flat
from repro_torch.core.distributed import SegmentedIndex
from repro_torch.core.index import INDEX_FIELDS, HybridIndex
from repro_torch.core.segment_pool import SegmentPool
from repro_torch.core.usms import (
    FusedVectors,
    QuantizedFusedVectors,
    SparseVec,
    corpus_nbytes_by_leaf,
)
from repro_torch.device import resolve_device

INGEST_SUBDIR = "ingest"  # legacy flat layout, still readable
INGEST_STEP_PREFIX = "ingest_step_"

_FP32_CORPUS = ("dense", "learned/.idx", "learned/.val", "lexical/.idx", "lexical/.val")
_INT8_CORPUS = ("dense_q", "dense_scale") + _FP32_CORPUS[1:]


def _corpus_paths(quantized: bool) -> list[str]:
    return [f".corpus/.{f}" for f in (_INT8_CORPUS if quantized else _FP32_CORPUS)]


def _index_paths(quantized: bool) -> list[str]:
    return _corpus_paths(quantized) + [f".{f}" for f in INDEX_FIELDS]


def _index_node(quantized: bool) -> str:
    sparse = "CustomNode(SparseVec[()], [*, *])"
    if quantized:
        corpus = f"CustomNode(QuantizedFusedVectors[()], [*, *, {sparse}, {sparse}])"
    else:
        corpus = f"CustomNode(FusedVectors[()], [*, {sparse}, {sparse}])"
    return f"CustomNode(HybridIndex[()], [{corpus}, " + ", ".join(["*"] * len(INDEX_FIELDS)) + "])"


def _pool_node(group_dtypes) -> str:
    groups = ", ".join(f"CustomNode(SegmentedIndex[()], [{_index_node(d == 'int8')}, *])"
                       for d in group_dtypes)
    return f"CustomNode(SegmentPool[()], [[{groups}]])"


def _quantized(corpus) -> bool:
    return isinstance(corpus, QuantizedFusedVectors)


def _dtype(corpus) -> str:
    return "int8" if _quantized(corpus) else "float32"


def _index_flat(index: HybridIndex, prefix: str = "") -> list:
    leaves = index._leaves()
    return [(prefix + p, t) for p, t in zip(_index_paths(_quantized(index.corpus)), leaves)]


def _pool_flat(pool: SegmentPool) -> list:
    flat = []
    for g, group in enumerate(pool.groups):
        base = f".groups/[{g}]/"
        flat += _index_flat(group.index, base + ".index/")
        flat.append((base + ".global_ids", group.global_ids))
    return flat


def _corpus_record(corpus) -> dict:
    """The manifest quantization record for one corpus: storage dtype, scale
    layout, and the compression ratio against equivalent fp32 storage."""
    quantized = _quantized(corpus)
    actual = int(sum(corpus_nbytes_by_leaf(corpus).values()))
    if quantized:
        dd = corpus.dense_q.shape[-1]
        rows = int(np.prod(corpus.dense_q.shape[:-1]))
        ps = corpus.learned.idx.shape[-1]
        pf = corpus.lexical.idx.shape[-1]
        fp32 = rows * (dd * 4 + ps * 8 + pf * 8)  # idx int32 + val f32
    else:
        fp32 = actual
    return {
        "corpus_dtype": "int8" if quantized else "float32",
        "scale_layout": "per_row_symmetric" if quantized else None,
        "corpus_bytes": actual,
        "corpus_bytes_fp32": fp32,
        "compression_ratio": (fp32 / actual) if actual else 1.0,
    }


def _manifest_extra(tree) -> dict:
    """Quantization metadata merged into the manifest; for a pool also the
    per-group dtype list, the load-time group template (a mixed fp32/int8
    pool has groups of different leaf counts)."""
    if isinstance(tree, SegmentPool):
        records = [_corpus_record(g.index.corpus) for g in tree.groups]
        actual = sum(r["corpus_bytes"] for r in records)
        fp32 = sum(r["corpus_bytes_fp32"] for r in records)
        any_int8 = any(r["corpus_dtype"] == "int8" for r in records)
        return {
            "pool_groups": [r["corpus_dtype"] for r in records],
            "quantization": {
                "corpus_dtype": "int8" if any_int8 else "float32",
                "scale_layout": "per_row_symmetric" if any_int8 else None,
                "corpus_bytes": actual,
                "corpus_bytes_fp32": fp32,
                "compression_ratio": (fp32 / actual) if actual else 1.0,
            },
        }
    return {"quantization": _corpus_record(tree.corpus)}


def _save_stepped(directory: pathlib.Path, treedef: str, flat, extra: dict, keep: int,
                  ingest=None) -> None:
    """A fresh step per save: the previous committed step is only collected
    by retention AFTER the new one's ``.done`` lands, so a crash mid-save
    always leaves a committed index behind. The paired ingest manifest is
    written before the step commits."""
    steps = all_steps(directory)
    step = steps[-1] + 1 if steps else 0
    if ingest is not None:
        ingest.save(directory / f"{INGEST_STEP_PREFIX}{step}")
    save_flat(directory, step, treedef, flat, keep=keep, extra=extra)
    # ingest manifests whose index step retention dropped
    kept = set(all_steps(directory))
    for d in directory.glob(INGEST_STEP_PREFIX + "*"):
        try:
            s = int(d.name[len(INGEST_STEP_PREFIX):])
        except ValueError:
            continue
        if s not in kept and s != step:
            shutil.rmtree(d, ignore_errors=True)


def save_index(directory: str | os.PathLike, index: HybridIndex, *, ingest=None,
               keep: int = 1) -> None:
    """Atomically persist ``index`` as a fresh committed step, paired with
    the fitted ``ingest.IngestPipeline`` whose frozen stats produced its
    vectors when ``ingest`` is given."""
    tree = f"PyTreeDef({_index_node(_quantized(index.corpus))})"
    _save_stepped(pathlib.Path(directory), tree, _index_flat(index), _manifest_extra(index),
                  keep, ingest)


def save_pool(directory: str | os.PathLike, pool: SegmentPool, *, ingest=None,
              keep: int = 1) -> None:
    """Atomically persist a heterogeneous ``SegmentPool`` (any group count,
    per-group segment counts, capacities and storage dtypes), paired with
    ``ingest`` when given."""
    tree = f"PyTreeDef({_pool_node([_dtype(g.index.corpus) for g in pool.groups])})"
    _save_stepped(pathlib.Path(directory), tree, _pool_flat(pool), _manifest_extra(pool), keep,
                  ingest)


def _committed(directory: pathlib.Path, step: Optional[int], what: str):
    steps = all_steps(directory)
    if not steps:
        raise FileNotFoundError(f"no committed {what} checkpoint under {directory}")
    step = steps[-1] if step is None else step
    if step not in steps:
        raise FileNotFoundError(f"step {step} not committed under {directory}")
    d = directory / f"step_{step}"
    with open(d / "manifest.json") as f:
        return d, json.load(f)


def _leaves(d: pathlib.Path, manifest: dict, paths: list[str], device, what: str) -> list:
    metas = manifest["leaves"]
    if len(metas) != len(paths):
        raise ValueError(f"manifest has {len(metas)} leaves but a {what} has {len(paths)} — "
                         f"not a {what} checkpoint?")
    if manifest.get("paths", paths) != paths:
        raise ValueError(f"checkpoint paths differ from a {what}'s — not a {what} checkpoint?")
    return [load_leaf(d / f"leaf_{i}.npy", m).to(device) for i, m in enumerate(metas)]


def _index_from(leaves: list) -> HybridIndex:
    if len(leaves) == 5 + len(INDEX_FIELDS):
        d, li, lv, xi, xv = leaves[:5]
        corpus = FusedVectors(d, SparseVec(li, lv), SparseVec(xi, xv))
    else:
        dq, sc, li, lv, xi, xv = leaves[:6]
        corpus = QuantizedFusedVectors(dq, sc, SparseVec(li, lv), SparseVec(xi, xv))
    rest = leaves[len(leaves) - len(INDEX_FIELDS):]
    return HybridIndex(corpus=corpus, **dict(zip(INDEX_FIELDS, rest)))


def load_index(directory: str | os.PathLike, *, step: Optional[int] = None,
               device=None) -> HybridIndex:
    """Restore a saved index on ``device`` (``None`` -> CUDA). Only committed
    steps (``.done`` marker) are trusted."""
    dev = resolve_device(device)
    d, manifest = _committed(pathlib.Path(directory), step, "index")
    # int8 leaves appear only in quantized dense storage
    quantized = any(m["dtype"] == "int8" for m in manifest["leaves"])
    return _index_from(_leaves(d, manifest, _index_paths(quantized), dev, "index"))


def load_pool(directory: str | os.PathLike, *, step: Optional[int] = None,
              device=None) -> SegmentPool:
    """Restore a saved ``SegmentPool`` on ``device`` (``None`` -> CUDA). The
    group layout comes from the manifest's ``pool_groups``; a legacy
    manifest without it is read as uniform fp32 groups."""
    dev = resolve_device(device)
    d, manifest = _committed(pathlib.Path(directory), step, "pool")
    n_leaves = len(manifest["leaves"])
    group_dtypes = manifest.get("pool_groups")
    if group_dtypes is None:
        stride = len(_index_paths(False)) + 1
        if n_leaves == 0 or n_leaves % stride:
            raise ValueError(f"manifest has {n_leaves} leaves, not a multiple of {stride} — "
                             "not a segment-pool checkpoint?")
        group_dtypes = ["float32"] * (n_leaves // stride)
    paths = []
    for g, dtype in enumerate(group_dtypes):
        base = f".groups/[{g}]/"
        paths += [base + ".index/" + p for p in _index_paths(dtype == "int8")]
        paths.append(base + ".global_ids")
    leaves = _leaves(d, manifest, paths, dev, "pool")
    groups, i = [], 0
    for dtype in group_dtypes:
        n = len(_index_paths(dtype == "int8"))
        groups.append(SegmentedIndex(_index_from(leaves[i:i + n]), leaves[i + n]))
        i += n + 1
    return SegmentPool(groups=groups)


def load_ingest(directory: str | os.PathLike, *, device=None):
    """The fitted ``ingest.IngestPipeline`` paired with the latest committed
    step, encoding onto ``device`` (``None`` -> CUDA). Falls back to the
    legacy flat ``ingest/`` layout."""
    from repro_torch.ingest.pipeline import IngestPipeline

    directory = pathlib.Path(directory)
    steps = all_steps(directory)
    if steps:
        stepped = directory / f"{INGEST_STEP_PREFIX}{steps[-1]}"
        if stepped.exists():
            return IngestPipeline.load(stepped, device=device)
    return IngestPipeline.load(directory / INGEST_SUBDIR, device=device)


