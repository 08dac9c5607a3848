"""Hybrid distance by id (paper §4.1 Step 1): kernel wrapper + plain version.

Replaces ``repro/kernels/hybrid_distance.py::hybrid_distance_pallas`` (fp32;
the int8 ``has_scale`` variant waits for the quantized slice). The CUDA
kernel is ``csrc/hybrid_distance.cu``: it gathers candidate rows by id
inside the kernel, so the ``(B, C, Dd)`` gathered copy that ``repro`` builds
with ``corpus.take`` never exists, and it intersects ELL rows by binary
search over the query's sorted ids instead of Pq x Pc compares. Bound on the
H100: bytes (one Dd-float row per live candidate); the design streams each
row once with coalesced float4 loads, one warp per candidate.

``hybrid_distance(q, corpus, ids)`` launches the kernel for CUDA tensors and
takes the plain version for CPU tensors; there is no fallback between them.
"""

from __future__ import annotations

import torch

from repro_torch.core.usms import FusedVectors
from repro_torch.kernels import _build, ref


def hybrid_distance_plain(q: FusedVectors, corpus: FusedVectors, ids: torch.Tensor) -> torch.Tensor:
    """Plain version: gather rows (PAD -> row 0), score, mask PAD to -inf."""
    scores = ref.hybrid_scores_ref(q, corpus.take(ids))
    return torch.where(ids >= 0, scores, torch.full_like(scores, float("-inf")))


def tensors_device(*groups) -> torch.device:
    """The one device all given tensors lie on (raises on a mix)."""
    devs = {t.device for g in groups for t in (g.tensors() if isinstance(g, FusedVectors) else (g,))
            if t is not None}
    if len(devs) != 1:
        raise ValueError(f"tensors lie on several devices: {sorted(map(str, devs))}")
    return devs.pop()


def _need(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def check_fused(fv: FusedVectors, name: str, rows: int | None = None) -> None:
    """Validate a FusedVectors operand for the CUDA kernels: 2-D, contiguous,
    float32 dense/vals, int32 ids, matching row counts."""
    n = fv.dense.shape[0] if rows is None else rows
    _need(fv.dense.dim() == 2 and fv.dense.shape[0] == n, f"{name}.dense must be ({n}, Dd)")
    for leaf, t, dt in (
        ("dense", fv.dense, torch.float32),
        ("learned.idx", fv.learned.idx, torch.int32),
        ("learned.val", fv.learned.val, torch.float32),
        ("lexical.idx", fv.lexical.idx, torch.int32),
        ("lexical.val", fv.lexical.val, torch.float32),
    ):
        _need(t.dtype == dt, f"{name}.{leaf} must be {dt}, got {t.dtype}")
        _need(t.is_contiguous(), f"{name}.{leaf} must be contiguous")
        _need(t.dim() == 2 and t.shape[0] == n, f"{name}.{leaf} must have {n} rows")
    _need(fv.learned.idx.shape == fv.learned.val.shape, f"{name}.learned idx/val shapes differ")
    _need(fv.lexical.idx.shape == fv.lexical.val.shape, f"{name}.lexical idx/val shapes differ")


def check_ids(ids: torch.Tensor, rows: int, name: str = "ids") -> None:
    _need(ids.dim() == 2 and ids.shape[0] == rows, f"{name} must be ({rows}, C)")
    _need(ids.dtype == torch.int32, f"{name} must be int32, got {ids.dtype}")
    _need(ids.is_contiguous(), f"{name} must be contiguous")


def corpus_args(corpus: FusedVectors) -> list:
    """Pointer/shape arguments of a corpus, in the C functions' order."""
    vec4 = int(corpus.dense.shape[1] % 4 == 0 and corpus.dense.data_ptr() % 16 == 0)
    return [
        corpus.dense.data_ptr(),
        corpus.learned.idx.data_ptr(),
        corpus.learned.val.data_ptr(),
        corpus.lexical.idx.data_ptr(),
        corpus.lexical.val.data_ptr(),
        corpus.n,
        corpus.learned.idx.shape[1],
        corpus.lexical.idx.shape[1],
        vec4,
    ]


def query_args(q: FusedVectors) -> list:
    return [
        q.dense.data_ptr(),
        q.learned.idx.data_ptr(),
        q.learned.val.data_ptr(),
        q.lexical.idx.data_ptr(),
        q.lexical.val.data_ptr(),
        q.dense.shape[0],
        q.dense.shape[1],
        q.learned.idx.shape[1],
        q.lexical.idx.shape[1],
    ]


def check_query_corpus(q: FusedVectors, corpus: FusedVectors, ids: torch.Tensor) -> None:
    b = q.dense.shape[0]
    check_fused(q, "q", b)
    check_fused(corpus, "corpus")
    check_ids(ids, b)
    _need(q.dense.shape[1] == corpus.dense.shape[1], "query and corpus dense widths differ")
    _need(ids.shape[1] < 2**31 and b < 2**31, "B and C must fit in int32")


def hybrid_distance(q: FusedVectors, corpus: FusedVectors, ids: torch.Tensor) -> torch.Tensor:
    """(B, C) float32 scores of query b against corpus rows ``ids[b, c]``;
    PAD ids score -inf. CUDA tensors launch the kernel; CPU tensors take the
    plain version."""
    dev = tensors_device(q, corpus, ids)
    if dev.type == "cpu":
        return hybrid_distance_plain(q, corpus, ids)
    _need(dev.type == "cuda", f"no kernel for device {dev}")
    check_query_corpus(q, corpus, ids)
    b, c = ids.shape
    out = torch.empty((b, c), dtype=torch.float32, device=dev)
    if b == 0 or c == 0:
        return out
    lib = _build.library()
    (qd, qsi, qsv, qfi, qfv, _, dd, psq, pfq) = query_args(q)
    cd, csi, csv, cfi, cfv, n, psc, pfc, vec4 = corpus_args(corpus)
    rc = lib.hybrid_distance_launch(
        qd, qsi, qsv, qfi, qfv, b, dd, psq, pfq,
        cd, csi, csv, cfi, cfv, n, psc, pfc, vec4,
        ids.data_ptr(), c, out.data_ptr(), *_build.device_and_stream(out),
    )
    hybrid_distance.launches += 1
    _build.check(rc, "hybrid_distance")
    return out


hybrid_distance.launches = 0
