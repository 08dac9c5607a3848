"""Fused hybrid distance + top-k by id: kernel wrappers + plain versions.

Replaces ``repro/kernels/fused_topk.py::fused_topk_pallas`` in both forms:
fp32 storage (``fused_topk``) and int8 storage with a per-row scale, the
``has_scale`` variant (``fused_topk_int8``), each with bias on and off. The
CUDA kernels are ``csrc/fused_topk.cu``, one template over the two storage
views, in two forms chosen here by B x C (``ORDERED_MIN_PAIRS``):

* one pass, below it: one block per query row scores the row's candidates
  (rows gathered by id inside the kernel, PAD ids skipped, a warp per
  candidate at serving sizes) into shared memory and selects the top k
  there, so neither a gathered ``(B, C, Dd)`` copy nor the ``(B, C)`` score
  matrix reaches device memory;
* ordered, at or above it (the NN-Descent chunk): a counting sort orders the
  launch's live (id, position) pairs by id, a scoring pass walks them with
  each corpus row held in a warp's registers while its id repeats (so each
  unique row is read from HBM once) and writes the scores to an fp32
  ``(B, C)`` scratch in device memory, part of a workspace allocated here;
  a selection pass takes each row's top k.

Selection is a per-warp running top-k sorted by shuffles and one merge per
block (k <= 64), or k rounds of a block arg-max (k > 64). Bound on the H100:
bytes (each unique live row read once: Dd floats, or Dd int8 values + a
4-byte scale, plus its ELL slots). No 128-lane ``K_PAD``: the output is
``(B, k)``. Ties go to the lowest position, as ``lax.top_k``; empty slots
hold ``(NEG, PAD_IDX)``.
"""

from __future__ import annotations

import torch

from repro_torch.core.usms import FusedVectors, QuantizedFusedVectors
from repro_torch.kernels import _build, ref
from repro_torch.kernels.hybrid_distance import (
    _args,
    _device,
    _need,
    check_fused,
    check_ids,
    check_quantized,
    corpus_args,
    query_args,
)
from repro_torch.kernels.ref import NEG as NEG  # re-export: callers mask on it

# B x C at or above which a launch takes the ordered form (where the
# operands fit it: ELL widths <= 32 and Dd <= 1024 in 16-byte rows). On the
# main paths only the NN-Descent round chunk (2048 x 1032) is above it; the
# refinement chunk (2048 x 152), the descent inits and every search or
# serving round are below.
ORDERED_MIN_PAIRS = 1 << 20
ORDERED_MAX_SLOTS = 32  # csrc/fused_topk.cu kMaxSlots: a lane per ELL slot


def fused_topk_plain(
    q: FusedVectors,
    corpus: FusedVectors,
    ids: torch.Tensor,
    k: int,
    bias: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version: gather rows, score, bias, mask PAD to NEG, stable top-k."""
    return ref.fused_topk_ref(q, corpus.take(ids), ids, bias, k)


def fused_topk_int8_plain(
    q: FusedVectors,
    corpus: QuantizedFusedVectors,
    ids: torch.Tensor,
    k: int,
    bias: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version over int8 storage (``fused_topk_quant_ref``)."""
    return ref.fused_topk_quant_ref(q, corpus.take(ids), ids, bias, k)


def _launch(fn_name: str, q: FusedVectors, corpus, ids: torch.Tensor, k: int,
            bias: torch.Tensor | None) -> tuple[torch.Tensor, torch.Tensor]:
    quant = isinstance(corpus, QuantizedFusedVectors)
    dense = corpus.dense_q if quant else corpus.dense
    qa, qdev = _args(q, lambda f: check_fused(f, "q"), query_args)
    ca, cdev = _args(corpus, (lambda f: check_quantized(f, "corpus")) if quant
                     else (lambda f: check_fused(f, "corpus")), corpus_args)
    b, dd, psq, pfq = qa[5:9]
    check_ids(ids, b)
    c = ids.shape[1]
    _need(qdev == cdev == ids.device, "q, corpus and ids must lie on one device")
    _need(dense.shape[1] == dd, "query and corpus dense widths differ")
    _need(c < 2**31 and b < 2**31, "B and C must fit in int32")
    if bias is not None:
        _need(bias.shape == ids.shape, "bias must have the shape of ids")
        _need(bias.device == ids.device, "bias must lie on the device of ids")
        _need(bias.dtype == torch.float32 and bias.is_contiguous(),
              "bias must be contiguous float32")
    out_s = torch.empty((b, k), dtype=torch.float32, device=ids.device)
    out_i = torch.empty((b, k), dtype=torch.int32, device=ids.device)
    if b == 0:
        return out_s, out_i
    if c == 0:
        return out_s.fill_(NEG), out_i.fill_(-1)
    lib = _build.library()
    workspace = None
    if b * c >= ORDERED_MIN_PAIRS and _ordered_fits(lib, q, corpus, ca[-1]):
        workspace = torch.empty(lib.fused_topk_workspace_bytes(b, c, corpus.n),
                                dtype=torch.uint8, device=ids.device)
    else:
        smem = lib.fused_topk_smem_bytes(b, dd, psq, pfq, c)
        _need(smem <= _build.MAX_SMEM_BYTES - 1024,
              f"fused_topk: C={c} at Dd={dd} needs {smem} B of shared memory")
    rc = getattr(lib, fn_name)(
        *qa[:5], b, dd, psq, pfq, *ca, ids.data_ptr(), _build.ptr(bias), c, k,
        out_s.data_ptr(), out_i.data_ptr(), _build.ptr(workspace),
        *_build.device_and_stream(out_s),
    )
    _build.check(rc, fn_name)
    return out_s, out_i


def _ordered_fits(lib, q: FusedVectors, corpus, vec: int) -> bool:
    """Whether the operands fit the ordered form's layout: a corpus row held
    in a warp's registers (16-byte dense rows of Dd <= 1024, a lane per ELL
    slot) and the query rows read as 16-byte words."""
    widths = (q.learned.idx.shape[1], q.lexical.idx.shape[1], corpus.learned.idx.shape[1],
              corpus.lexical.idx.shape[1])
    dd = q.dense.shape[1]
    return (max(widths) <= ORDERED_MAX_SLOTS and vec == 1 and dd % 4 == 0
            and dd <= lib.fused_topk_ordered_max_dd() and q.dense.data_ptr() % 16 == 0)


def fused_topk(
    q: FusedVectors,
    corpus: FusedVectors,
    ids: torch.Tensor,
    k: int,
    bias: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k ``(scores, positions)`` (B, k) of query b over corpus rows
    ``ids[b, :]`` (+ ``bias``). CUDA tensors launch the kernel; CPU tensors
    take the plain version."""
    if k < 1:
        raise ValueError(f"top-k needs k >= 1, got {k}")
    if _device(q, corpus, ids, bias) == "cpu":
        return fused_topk_plain(q, corpus, ids, k, bias)
    _need(isinstance(corpus, FusedVectors), "fused_topk takes fp32 storage")
    out = _launch("fused_topk_launch", q, corpus, ids, k, bias)
    fused_topk.launches += 1
    return out


def fused_topk_int8(
    q: FusedVectors,
    corpus: QuantizedFusedVectors,
    ids: torch.Tensor,
    k: int,
    bias: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``fused_topk`` over int8 storage (the ``has_scale`` variant): the same
    contract, the dense dot multiplied by the row scale. CUDA tensors launch
    the kernel; CPU tensors take the plain version."""
    if k < 1:
        raise ValueError(f"top-k needs k >= 1, got {k}")
    if _device(q, corpus, ids, bias) == "cpu":
        return fused_topk_int8_plain(q, corpus, ids, k, bias)
    _need(isinstance(corpus, QuantizedFusedVectors), "fused_topk_int8 takes int8 storage")
    out = _launch("fused_topk_q8_launch", q, corpus, ids, k, bias)
    fused_topk_int8.launches += 1
    return out


fused_topk.launches = 0
fused_topk_int8.launches = 0
