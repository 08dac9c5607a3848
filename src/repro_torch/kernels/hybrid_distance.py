"""Hybrid distance by id (paper §4.1 Step 1): kernel wrapper + plain version.

Replaces ``repro/kernels/hybrid_distance.py::hybrid_distance_pallas`` in
both forms: fp32 storage (``hybrid_distance``) and int8 storage with a
per-row scale, the ``has_scale`` variant (``hybrid_distance_int8``). The CUDA
kernel is ``csrc/hybrid_distance.cu``, one template over the two storage
views: it gathers candidate rows by id inside the kernel, so the
``(B, C, Dd)`` gathered copy that ``repro`` builds with ``corpus.take``
never exists, and it intersects ELL rows by binary search over the query's
sorted ids instead of Pq x Pc compares. Bound on the H100: bytes (one dense
row per live candidate: Dd floats, or Dd int8 values + a 4-byte scale).
Every row is scored by the row scorer ``fused_topk`` shares (a warp a row,
every load of the row in flight before any lookup), in one of two forms
picked here by C (``SMALL_C_MAX``):

* the warp form (C <= SMALL_C_MAX, every main-path launch: the build's
  self scores and per-path norms at C = 1, entry scoring at C = 16, the
  final re-score at C = 80): a warp holds one query row in registers, its
  ELL rows sorted across its lanes, and scores that row's candidates; no
  shared memory, no block barrier;
* the block form (larger C, or operands the warp form does not take): a
  block stages one query row in shared memory for its warps.

The int8 form multiplies the warp-reduced dense sum by the row scale
(DESIGN.md §13) and reads fp16 ELL values as fp16. Each score is one warp's
fixed-order sum: the same bits on every launch, in either form.

Each wrapper launches its kernel for CUDA tensors and takes its plain version
for CPU tensors; there is no fallback between them.
"""

from __future__ import annotations

import weakref

import torch

from repro_torch.core.usms import FusedVectors, QuantizedFusedVectors
from repro_torch.kernels import _build, ref

# C at or below which a launch takes the warp form (where the operands fit
# it: Dd <= 1024 floats in 16-byte rows, query ELL widths <= 32). Every main
# path's launch is at or below it: the self scores and per-path norms (C =
# 1), entry scoring (C = 16) and the final re-score (C = 80), where the warp
# form ran 0.2835 ms and the block form 0.3153 on an H100
# (examples/torch_pairwise_tile_ablation.py).
SMALL_C_MAX = 128
WARP_FORM_MAX_DD = 1024  # csrc/hybrid_distance.cu: rt::kQueryWords 16-byte words a lane
WARP_FORM_MAX_SLOTS = 32  # a lane per query ELL slot


def hybrid_distance_plain(q: FusedVectors, corpus: FusedVectors, ids: torch.Tensor) -> torch.Tensor:
    """Plain version: gather rows (PAD -> row 0), score, mask PAD to -inf."""
    scores = ref.hybrid_scores_ref(q, corpus.take(ids))
    return torch.where(ids >= 0, scores, torch.full_like(scores, float("-inf")))


def hybrid_distance_int8_plain(
    q: FusedVectors, corpus: QuantizedFusedVectors, ids: torch.Tensor
) -> torch.Tensor:
    """Plain version over int8 storage: gather, ``scale * <q, int8>`` +
    sparse, mask PAD to -inf."""
    scores = ref.hybrid_scores_quant_ref(q, corpus.take(ids))
    return torch.where(ids >= 0, scores, torch.full_like(scores, float("-inf")))


def _tensors(g) -> tuple:
    return g.tensors() if isinstance(g, (FusedVectors, QuantizedFusedVectors)) else (g,)


def tensors_device(*groups) -> torch.device:
    """The one device all given tensors lie on (raises on a mix)."""
    devs = {t.device for g in groups for t in _tensors(g) if t is not None}
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


def check_quantized(qv: QuantizedFusedVectors, name: str) -> None:
    """Validate a QuantizedFusedVectors operand for the int8 kernels: 2-D,
    contiguous, int8 dense, float32 scale, float16 vals, int32 ids."""
    n = qv.dense_q.shape[0]
    _need(qv.dense_q.dim() == 2, f"{name}.dense_q must be (N, Dd)")
    _need(qv.dense_scale.shape == (n,), f"{name}.dense_scale must be ({n},)")
    for leaf, t, dt in (
        ("dense_q", qv.dense_q, torch.int8),
        ("dense_scale", qv.dense_scale, torch.float32),
        ("learned.idx", qv.learned.idx, torch.int32),
        ("learned.val", qv.learned.val, torch.float16),
        ("lexical.idx", qv.lexical.idx, torch.int32),
        ("lexical.val", qv.lexical.val, torch.float16),
    ):
        _need(t.dtype == dt, f"{name}.{leaf} must be {dt}, got {t.dtype}")
        _need(t.is_contiguous(), f"{name}.{leaf} must be contiguous")
        _need(t.shape[0] == n, f"{name}.{leaf} must have {n} rows")
    for sv, path in ((qv.learned, "learned"), (qv.lexical, "lexical")):
        _need(sv.idx.dim() == 2 and sv.idx.shape == sv.val.shape,
              f"{name}.{path} idx/val must be equal (N, P)")


def check_ids(ids: torch.Tensor, rows: int, name: str = "ids") -> None:
    _need(ids.dim() == 2 and ids.shape[0] == rows, f"{name} must be ({rows}, C)")
    _need(ids.dtype == torch.int32, f"{name} must be int32, got {ids.dtype}")
    _need(ids.is_contiguous(), f"{name} must be contiguous")


def corpus_args(corpus) -> list:
    """Pointer/shape arguments of a corpus, in the C functions' order; an
    int8 corpus adds its scale pointer after the dense one. ``vec``: dense
    rows are 16-byte aligned, so the kernel loads 16 bytes per lane (4 floats
    or 16 int8 values)."""
    if isinstance(corpus, QuantizedFusedVectors):
        dense, lanes, extra = corpus.dense_q, 16, [corpus.dense_scale.data_ptr()]
    else:
        dense, lanes, extra = corpus.dense, 4, []
    vec = int(dense.shape[1] % lanes == 0 and dense.data_ptr() % 16 == 0)
    return [
        dense.data_ptr(),
        *extra,
        corpus.learned.idx.data_ptr(),
        corpus.learned.val.data_ptr(),
        corpus.lexical.idx.data_ptr(),
        corpus.lexical.val.data_ptr(),
        corpus.n,
        corpus.learned.idx.shape[1],
        corpus.lexical.idx.shape[1],
        vec,
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


def check_query_corpus(q: FusedVectors, corpus, ids: torch.Tensor) -> None:
    """Every operand check of a launch at once (the wrappers make them once
    per set of operand tensors, ``_args``)."""
    b = q.dense.shape[0]
    check_fused(q, "q", b)
    if isinstance(corpus, QuantizedFusedVectors):
        check_quantized(corpus, "corpus")
        dd = corpus.dense_q.shape[1]
    else:
        check_fused(corpus, "corpus")
        dd = corpus.dense.shape[1]
    check_ids(ids, b)
    _need(q.dense.shape[1] == dd, "query and corpus dense widths differ")
    _need(ids.shape[1] < 2**31 and b < 2**31, "B and C must fit in int32")


# Operands already checked, by the identity of their tensors: a search or a
# build hands the same query and corpus tensors to many launches, and the
# checks cost more host time than a small launch takes on the card.
_checked: dict = {}


def _args(fv, check, args) -> tuple:
    """(``args(fv)``, device) of an operand, checked once per set of tensors."""
    ts = fv.tensors()
    key = (args, id(ts[0]))
    hit = _checked.get(key)
    if (hit is not None and len(hit[0]) == len(ts)
            and all(r() is t and t.data_ptr() == p for r, t, p in zip(hit[0], ts, hit[1]))):
        return hit[2]
    devs = {t.device for t in ts}
    _need(len(devs) == 1, f"tensors lie on several devices: {sorted(map(str, devs))}")
    check(fv)
    out = (args(fv), devs.pop())
    if len(_checked) >= 64:
        _checked.clear()
    refs = tuple(weakref.ref(t) for t in ts)
    _checked[key] = (refs, tuple(t.data_ptr() for t in ts), out)
    return out


def _device(q, corpus, ids, bias=None) -> str:
    """"cpu" (the plain version), "cuda" (the kernel), or raise."""
    if ids.device.type == "cuda":
        return "cuda"  # the launch checks that every operand lies there
    dev = tensors_device(q, corpus, ids, bias)
    _need(dev.type == "cpu", f"no kernel for device {dev}")
    return "cpu"


def _warp_form(qa: list, ca: list, c: int) -> bool:
    qd, dd, psq, pfq, vec = qa[0], qa[6], qa[7], qa[8], ca[-1]
    return (c <= SMALL_C_MAX and vec == 1 and dd % 4 == 0 and dd <= WARP_FORM_MAX_DD
            and qd % 16 == 0 and max(psq, pfq) <= WARP_FORM_MAX_SLOTS)


def warp_form(q: FusedVectors, corpus, c: int) -> bool:
    """Whether a launch of C candidates per query row takes the warp form:
    C <= SMALL_C_MAX and the operands fit it (16-byte query and corpus rows,
    Dd <= 1024, query ELL widths <= 32)."""
    return _warp_form(query_args(q), corpus_args(corpus), c)


def _launch(fn_name: str, q: FusedVectors, corpus, ids: torch.Tensor) -> torch.Tensor:
    quant = isinstance(corpus, QuantizedFusedVectors)
    qa, qdev = _args(q, lambda f: check_fused(f, "q"), query_args)
    ca, cdev = _args(corpus, (lambda f: check_quantized(f, "corpus")) if quant
                     else (lambda f: check_fused(f, "corpus")), corpus_args)
    b, dd, psq, pfq = qa[5:9]
    check_ids(ids, b)
    c = ids.shape[1]
    _need(qdev == cdev == ids.device, "q, corpus and ids must lie on one device")
    _need((corpus.dense_q if quant else corpus.dense).shape[1] == dd,
          "query and corpus dense widths differ")
    _need(c < 2**31 and b < 2**31, "B and C must fit in int32")
    out = torch.empty((b, c), dtype=torch.float32, device=ids.device)
    if b == 0 or c == 0:
        return out
    lib = _build.library()
    rc = getattr(lib, fn_name)(
        *qa[:5], b, dd, psq, pfq, *ca, ids.data_ptr(), c, int(_warp_form(qa, ca, c)),
        out.data_ptr(), *_build.device_and_stream(out),
    )
    _build.check(rc, fn_name)
    return out


def hybrid_distance(q: FusedVectors, corpus: FusedVectors, ids: torch.Tensor) -> torch.Tensor:
    """(B, C) float32 scores of query b against corpus rows ``ids[b, c]``;
    PAD ids score -inf. CUDA tensors launch the kernel; CPU tensors take the
    plain version."""
    if _device(q, corpus, ids) == "cpu":
        return hybrid_distance_plain(q, corpus, ids)
    _need(isinstance(corpus, FusedVectors), "hybrid_distance takes fp32 storage")
    out = _launch("hybrid_distance_launch", q, corpus, ids)
    hybrid_distance.launches += 1
    return out


def hybrid_distance_int8(
    q: FusedVectors, corpus: QuantizedFusedVectors, ids: torch.Tensor
) -> torch.Tensor:
    """``hybrid_distance`` over int8 storage (the ``has_scale`` variant): the
    same contract, the dense dot multiplied by the row scale. CUDA tensors
    launch the kernel; CPU tensors take the plain version."""
    if _device(q, corpus, ids) == "cpu":
        return hybrid_distance_int8_plain(q, corpus, ids)
    _need(isinstance(corpus, QuantizedFusedVectors), "hybrid_distance_int8 takes int8 storage")
    out = _launch("hybrid_distance_q8_launch", q, corpus, ids)
    hybrid_distance_int8.launches += 1
    return out


hybrid_distance.launches = 0
hybrid_distance_int8.launches = 0
