#!/usr/bin/env python3
"""Segment-sharded distributed search over a ("pod", "data", "model") mesh:
the production layout of the hybrid index in the PyTorch port, the
counterpart of ``examples/distributed_search.py``.

One process per rank. On the CPU, eight gloo ranks on a (2, 2, 2) mesh:

    PYTHONPATH=src torchrun --nproc-per-node 8 examples/torch_distributed_search.py --device cpu

On GPUs, one rank per card over NCCL (8 ranks make the (2, 2, 2) mesh; 1, 2
or 4 make (1, W, 1)):

    PYTHONPATH=src torchrun --nproc-per-node 8 examples/torch_distributed_search.py

The same corpus as the reference (2,048 docs, d 48, seed 5) as 4 segments,
built in parallel (``build_index_sharded``, segment s from seed 0 + s), each
rank holding its block; queries sharded over the model axis. Rank 0 prints
recall@10 against brute force and the nodes expanded across the mesh.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.core import BuildConfig, FusionSpec, KnnConfig, PruneConfig  # noqa: E402
from repro_torch.core.distributed import (  # noqa: E402
    build_index_sharded,
    make_distributed_search,
    mesh_segment_count,
    place_segmented_index,
)
from repro_torch.core.search import SearchParams  # noqa: E402
from repro_torch.core.usms import weighted_query  # noqa: E402
from repro_torch.data.corpus import CorpusConfig, make_corpus, recall_at_k  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.mesh import make_mesh, mesh_device  # noqa: E402

N_SEGMENTS = 4  # pod x data groups


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    shape = (2, 2, 2) if world == 8 else (1, world, 1)
    mesh = make_mesh(shape, ("pod", "data", "model"), device_type=args.device)
    lead = dist.get_rank() == 0
    if lead:
        print(f"mesh: {dict(zip(mesh.mesh_dim_names, mesh.shape))} = {world} ranks "
              f"({args.device}, {dist.get_backend()})")
    dev = mesh_device(mesh)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    corpus = make_corpus(CorpusConfig(n_docs=2048, n_queries=16, d_dense=48, seed=5), device=dev)

    seg = build_index_sharded(
        corpus.docs, N_SEGMENTS,
        BuildConfig(knn=KnnConfig(k=16, iters=4, node_chunk=1024),
                    prune=PruneConfig(degree=16, keyword_degree=4, node_chunk=512),
                    path_refine_iters=1),
        mesh=mesh)
    block = place_segmented_index(seg, mesh)
    if lead:
        print(f"{N_SEGMENTS} segments x {seg.global_ids.shape[1]} docs, "
              f"{block.n_segments} a rank on {mesh_segment_count(mesh)} segment devices, "
              "queries sharded over the model axis")

    spec = FusionSpec.three_path()
    run = make_distributed_search(mesh, spec, SearchParams(k=10, iters=32, pool_size=64))
    res = run(block, corpus.queries)

    qw = weighted_query(corpus.queries, spec.weights)
    truth = ops.topk_hybrid(qw, corpus.docs, 10)[1]
    if lead:
        print(f"global recall@10 vs brute force: {recall_at_k(res.ids, truth):.3f}")
        print(f"total nodes expanded across devices: {int(res.expanded[0])}")
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
