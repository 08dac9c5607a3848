"""Fused hybrid distance + top-k by id: kernel wrapper + plain version.

Replaces ``repro/kernels/fused_topk.py::fused_topk_pallas`` (fp32, bias on
and off; the int8 variant waits for the quantized slice). The CUDA kernel is
``csrc/fused_topk.cu``: one block per query row scores the row's candidates
(rows gathered by id inside the kernel, PAD ids skipped) into shared memory
and selects the top k there, so neither a gathered ``(B, C, Dd)`` copy nor
the ``(B, C)`` score matrix reaches device memory. Bound on the H100: bytes
(one Dd-float row per live candidate). No 128-lane ``K_PAD``: the output is
``(B, k)``. Ties go to the lowest position, as ``lax.top_k``; empty slots
hold ``(NEG, PAD_IDX)``.
"""

from __future__ import annotations

import torch

from repro_torch.core.usms import FusedVectors
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
    check_query_corpus(q, corpus, ids)
    b, c = ids.shape
    if bias is not None:
        _need(bias.shape == ids.shape, "bias must have the shape of ids")
        _need(bias.dtype == torch.float32 and bias.is_contiguous(),
              "bias must be contiguous float32")
    out_s = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    if b == 0:
        return out_s, out_i
    if c == 0:
        return out_s.fill_(NEG), out_i.fill_(-1)
    lib = _build.library()
    (qd, qsi, qsv, qfi, qfv, _, dd, psq, pfq) = query_args(q)
    smem = lib.fused_topk_smem_bytes(dd, psq, pfq, c)
    _need(smem <= _build.MAX_SMEM_BYTES - 1024,
          f"fused_topk: C={c} at Dd={dd} needs {smem} B of shared memory")
    cd, csi, csv, cfi, cfv, n, psc, pfc, vec4 = corpus_args(corpus)
    rc = lib.fused_topk_launch(
        qd, qsi, qsv, qfi, qfv, b, dd, psq, pfq,
        cd, csi, csv, cfi, cfv, n, psc, pfc, vec4,
        ids.data_ptr(), _build.ptr(bias), c, k,
        out_s.data_ptr(), out_i.data_ptr(), *_build.device_and_stream(out_s),
    )
    fused_topk.launches += 1
    _build.check(rc, "fused_topk")
    return out_s, out_i


fused_topk.launches = 0
