"""Candidate-pairwise score tiles by id (paper §4.1 Step 2): kernel wrapper
+ plain version.

Replaces ``repro/kernels/pairwise_tile.py::pairwise_tile_pallas``. The CUDA
kernel is ``csrc/pairwise_tile.cu``: one block per node loads the node's K
candidate rows once, by id (no gathered ``(C, K, Dd)`` copy and no
row-major + nnz-major double layout), tiles the dense K x K products over
Dd through shared memory, and intersects each pair's ELL rows by binary
search over rank-sorted ids. Bound on the H100: bytes (~16 flop per byte
at K = 32, Dd = 1024, below the fp32 ridge). Masking stays with the caller.
"""

from __future__ import annotations

import torch

from repro_torch.core.usms import FusedVectors
from repro_torch.kernels import _build, ref
from repro_torch.kernels.hybrid_distance import _need, check_fused, check_ids, tensors_device


def pairwise_tile_plain(corpus: FusedVectors, ids: torch.Tensor) -> torch.Tensor:
    """Plain version: gather each node's K rows (PAD -> row 0), all pairs."""
    return ref.pairwise_tile_ref(corpus.take(ids))


def pairwise_tile(corpus: FusedVectors, ids: torch.Tensor) -> torch.Tensor:
    """(C, K, K) float32: out[c, i, j] = score(row ids[c, i], row ids[c, j]).
    ``ids`` must lie in [0, N) (the caller clips PAD, as ``repro`` gathers
    PAD as row 0). CUDA tensors launch the kernel; CPU tensors take the
    plain version."""
    dev = tensors_device(corpus, ids)
    if dev.type == "cpu":
        return pairwise_tile_plain(corpus, ids)
    _need(dev.type == "cuda", f"no kernel for device {dev}")
    check_fused(corpus, "corpus")
    nodes, k = ids.shape
    check_ids(ids, nodes)
    out = torch.empty((nodes, k, k), dtype=torch.float32, device=dev)
    if nodes == 0 or k == 0:
        return out
    lib = _build.library()
    _need(k <= lib.pairwise_tile_max_k(), f"pairwise_tile takes K <= {lib.pairwise_tile_max_k()}")
    ps, pf = corpus.learned.idx.shape[1], corpus.lexical.idx.shape[1]
    _need(lib.pairwise_tile_smem_bytes(k, ps, pf) <= _build.MAX_SMEM_BYTES,
          "pairwise_tile: K and nnz caps exceed shared memory")
    rc = lib.pairwise_tile_launch(
        corpus.dense.data_ptr(), corpus.learned.idx.data_ptr(), corpus.learned.val.data_ptr(),
        corpus.lexical.idx.data_ptr(), corpus.lexical.val.data_ptr(),
        corpus.n, corpus.dense.shape[1], ps, pf,
        ids.data_ptr(), nodes, k, out.data_ptr(), *_build.device_and_stream(out),
    )
    pairwise_tile.launches += 1
    _build.check(rc, "pairwise_tile")
    return out


pairwise_tile.launches = 0
