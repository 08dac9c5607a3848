"""The yardstick's work counts and the H100's published peaks.

Frozen copies of ``chip_smoke.py``'s ``row_bytes`` / ``bound`` /
``scoring_work`` / ``tile_work``, taking plain shapes and id tensors so the
count stays the same whatever kernel does the work: each input byte counted
once (a unique live corpus row, a query row, an id), each output byte once,
and the dense products of the live (query, row) pairs as the operations.
"""

from __future__ import annotations

import torch

# NVIDIA H100 SXM data sheet, dense rates, at the 700 W power limit
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12  # CUDA cores
TF32_FLOP_PER_S = 495e12  # tensor cores: the pair tiles' 3xTF32 Gram


def row_bytes(d_dense: int, slots: int, int8: bool) -> int:
    """One stored row: fp32 dense + 8 B per ELL slot (int32 id, fp32 value),
    or int8 dense + a 4-byte scale + 6 B per ELL slot (fp16 value)."""
    return d_dense + 4 + slots * 6 if int8 else d_dense * 4 + slots * 8


def bound_s(nbytes: float, flops: float, flop_rate: float) -> tuple[float, str]:
    """The least time the card could take, and which term sets it."""
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / flop_rate
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def scoring_work(n_query: int, query_row: int, corpus_row: int, d_dense: int,
                 ids: torch.Tensor, out_bytes: int) -> tuple[float, float]:
    """A scoring launch (fused top-k or distance by id): bytes of each unique
    live corpus row, the query rows, the ids and the output, read or written
    once; operations of the live pairs' dense products."""
    live = ids[ids >= 0]
    uniq = int(torch.unique(live).numel())
    nbytes = uniq * corpus_row + n_query * query_row + ids.numel() * 4 + out_bytes
    return float(nbytes), 2.0 * d_dense * int(live.numel())


def tile_work(corpus_row: int, d_dense: int, ids: torch.Tensor) -> tuple[float, float]:
    """A pair-tile launch over (C, K) candidate ids: each unique live row read
    once, the ids, the (C, K, K) fp32 output; 2 K^2 Dd operations a node."""
    c, k = ids.shape
    uniq = int(torch.unique(ids[ids >= 0]).numel())
    nbytes = uniq * corpus_row + ids.numel() * 4 + c * k * k * 4
    return float(nbytes), 2.0 * d_dense * c * k * k
