"""Fused hybrid distance + top-k by id: kernel wrappers + plain versions.

Replaces ``repro/kernels/fused_topk.py::fused_topk_pallas`` in both forms:
fp32 storage (``fused_topk``) and int8 storage with a per-row scale, the
``has_scale`` variant (``fused_topk_int8``), each with bias on and off. The
CUDA kernel is ``csrc/fused_topk.cu``, one template over the two storage
views: one block per query row scores the row's candidates (rows gathered by
id inside the kernel, PAD ids skipped) into shared memory and selects the top
k there, so neither a gathered ``(B, C, Dd)`` copy nor the ``(B, C)`` score
matrix reaches device memory. Bound on the H100: bytes (one dense row per
live candidate: Dd floats, or Dd int8 values + a 4-byte scale). No 128-lane
``K_PAD``: the output is ``(B, k)``. Ties go to the lowest position, as
``lax.top_k``; empty slots hold ``(NEG, PAD_IDX)``.
"""

from __future__ import annotations

import torch

from repro_torch.core.usms import FusedVectors, QuantizedFusedVectors
from repro_torch.kernels import _build, ref
from repro_torch.kernels.hybrid_distance import (
    _need,
    check_query_corpus,
    corpus_args,
    query_args,
    tensors_device,
)
from repro_torch.kernels.ref import NEG as NEG  # re-export: callers mask on it


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
    check_query_corpus(q, corpus, ids)
    b, c = ids.shape
    if bias is not None:
        _need(bias.shape == ids.shape, "bias must have the shape of ids")
        _need(bias.dtype == torch.float32 and bias.is_contiguous(),
              "bias must be contiguous float32")
    out_s = torch.empty((b, k), dtype=torch.float32, device=ids.device)
    out_i = torch.empty((b, k), dtype=torch.int32, device=ids.device)
    if b == 0:
        return out_s, out_i
    if c == 0:
        return out_s.fill_(NEG), out_i.fill_(-1)
    lib = _build.library()
    (qd, qsi, qsv, qfi, qfv, _, dd, psq, pfq) = query_args(q)
    smem = lib.fused_topk_smem_bytes(dd, psq, pfq, c)
    _need(smem <= _build.MAX_SMEM_BYTES - 1024,
          f"fused_topk: C={c} at Dd={dd} needs {smem} B of shared memory")
    rc = getattr(lib, fn_name)(
        qd, qsi, qsv, qfi, qfv, b, dd, psq, pfq, *corpus_args(corpus),
        ids.data_ptr(), _build.ptr(bias), c, k,
        out_s.data_ptr(), out_i.data_ptr(), *_build.device_and_stream(out_s),
    )
    _build.check(rc, fn_name)
    return out_s, out_i


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
    dev = tensors_device(q, corpus, ids, bias)
    if dev.type == "cpu":
        return fused_topk_plain(q, corpus, ids, k, bias)
    _need(dev.type == "cuda", f"no kernel for device {dev}")
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
    dev = tensors_device(q, corpus, ids, bias)
    if dev.type == "cpu":
        return fused_topk_int8_plain(q, corpus, ids, k, bias)
    _need(dev.type == "cuda", f"no kernel for device {dev}")
    _need(isinstance(corpus, QuantizedFusedVectors), "fused_topk_int8 takes int8 storage")
    out = _launch("fused_topk_q8_launch", q, corpus, ids, k, bias)
    fused_topk_int8.launches += 1
    return out


fused_topk.launches = 0
fused_topk_int8.launches = 0
