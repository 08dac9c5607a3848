"""Candidate-pairwise score tiles by id (paper §4.1 Step 2): kernel wrapper
+ plain version.

Replaces ``repro/kernels/pairwise_tile.py::pairwise_tile_pallas``. The CUDA
kernel is ``csrc/pairwise_tile.cu``: persistent blocks walk the nodes, each
node's K candidate rows loaded once, by id (no gathered ``(C, K, Dd)`` copy
and no row-major + nnz-major double layout), through a ring of
``cp.async`` stages over Dd; the dense K x K Gram runs on the tensor cores in
3xTF32 (each operand split hi + lo, three TF32 products into an fp32 sum:
fp32-grade results), each ELL row is sorted once by a warp, and a warp per
row intersects it with the others by binary search over the sorted ids, the
columns' sums reduced in a fixed order (identical rows give identical
outputs; repeated launches the same bits). Bound on the H100: bytes on
uniform ids, operations on a real prune chunk's shared hub rows. Masking
stays with the caller.
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
    dd = corpus.dense.shape[1]
    _need(lib.pairwise_tile_smem_bytes(k, dd, ps, pf) <= _build.MAX_SMEM_BYTES,
          "pairwise_tile: K and nnz caps exceed shared memory")
    vec = int(dd % 4 == 0 and corpus.dense.data_ptr() % 16 == 0)  # 16-byte row copies
    rc = lib.pairwise_tile_launch(
        corpus.dense.data_ptr(), corpus.learned.idx.data_ptr(), corpus.learned.val.data_ptr(),
        corpus.lexical.idx.data_ptr(), corpus.lexical.val.data_ptr(),
        corpus.n, dd, ps, pf, vec, ids.data_ptr(), nodes, k, out.data_ptr(),
        *_build.device_and_stream(out),
    )
    pairwise_tile.launches += 1
    _build.check(rc, "pairwise_tile")
    return out


pairwise_tile.launches = 0
