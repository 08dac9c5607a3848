"""One rank of the port's mesh tests, on the CPU under gloo.

    python -m tests.torch_dist_ranks CASE[,CASE...] --rank R --world W \\
        --shape 2,2,2 --axes pod,data,model --store FILE --dir DIR

``tests/test_torch_distributed.py`` spawns one process per rank (repo root as
the working directory, ``src`` on ``PYTHONPATH``); each reads
``DIR/inputs.npz``, which the test wrote from repro's arrays, runs the cases
in order and writes ``DIR/rank{R}.npz``. Imports torch and repro_torch
only. Every collective has the mesh's timeout, so a rank left alone raises
instead of hanging.
"""

from __future__ import annotations

import argparse
import dataclasses
import pathlib
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import distributed as tdist
from repro_torch.core import segment_pool as tpool
from repro_torch.core.build_pipeline import BuildDraws
from repro_torch.core.fusion import FusionSpec, PathStats
from repro_torch.core.index import BuildConfig
from repro_torch.core.knn_graph import KnnConfig
from repro_torch.core.pruning import PruneConfig
from repro_torch.core.search import SearchParams
from repro_torch.core.usms import FusedVectors, SparseVec
from repro_torch.launch.mesh import make_mesh, mesh_dp_size, mesh_model_size
from repro_torch.serving.hybrid_service import (
    HybridSearchService,
    _args_from_flat,
    _segmented_from_leaves,
    follow,
)

KNN = dict(k=12, iters=2, node_chunk=64)
PRUNE = dict(degree=8, keyword_degree=3, node_chunk=64)
T_CFG = BuildConfig(knn=KnnConfig(**KNN), prune=PruneConfig(**PRUNE), path_refine_iters=1)
N_SEG = 8  # segments of the repro-built index
MODES = ["weighted_sum", "minmax", "zscore", "rrf"] * 2
SEARCH = dict(k=6, iters=24, pool_size=32, use_keywords=True)
POOL_GROUPS = ((0, 4), (4, 7))  # a group of 4 segments and one of 3
# the router case: degree-16 graphs over segments of <= 64 docs searched with
# iters and a pool past the docs, so every reachable doc is scored
R_KNN = dict(k=16, iters=4, node_chunk=64)
R_PRUNE = dict(degree=16, keyword_degree=4, node_chunk=64)
R_BUILD = BuildConfig(knn=KnnConfig(**R_KNN), prune=PruneConfig(**R_PRUNE), path_refine_iters=0)
R_SEARCH = SearchParams(k=8, iters=160, pool_size=160)
R_SEALED = ((0, 48), (48, 96))  # two sealed segments of the router's pool
R_INSERT = (96, 120)  # docs inserted through the router
R_DELETE = [3, 50, 97, 119, 4000]  # sealed, grow and unknown ids
R_SEED = 23
INGEST_SEED, INGEST_SEGMENTS, INGEST_DENSE = 5, 4, 32


def specs() -> list[FusionSpec]:
    """The batch's per-row fusion specs: every mode twice, stats resolved."""
    return [dataclasses.replace(FusionSpec.make(m, 1.0, 0.6, 0.3 + i / 10),
                                stats=PathStats.identity()) for i, m in enumerate(MODES)]


def params(dtype: str) -> SearchParams:
    return SearchParams(corpus_dtype=dtype, **SEARCH)


def load_seg(inp, prefix: str):
    n = int(inp[f"{prefix}_n"])
    return _segmented_from_leaves([torch.as_tensor(inp[f"{prefix}_{j}"]) for j in range(n)])


def save_seg(out: dict, prefix: str, seg) -> None:
    leaves = seg.leaves()
    out[f"{prefix}_n"] = np.asarray(len(leaves))
    for j, t in enumerate(leaves):
        out[f"{prefix}_{j}"] = t.cpu().numpy()


def load_args(inp, prefix: str):
    return _args_from_flat([torch.as_tensor(inp[f"{prefix}_{j}"]) for j in range(17)])


def load_draws(inp, s: int) -> BuildDraws:
    t = lambda k: torch.as_tensor(inp[k])
    rounds = [t(f"draws{s}_round{i}") for i in range(KNN["iters"])]
    paths = [[t(f"draws{s}_path{p}_{i}") for i in range(T_CFG.path_refine_iters)]
             for p in range(3)]
    return BuildDraws(init_graph=t(f"draws{s}_init"), rounds=rounds, path_rounds=paths)


def corpus_rows(inp, lo: int, hi: int) -> FusedVectors:
    t = lambda k: torch.as_tensor(inp[k][lo:hi])
    return FusedVectors(t("docs_dense"), SparseVec(t("docs_learned_idx"), t("docs_learned_val")),
                        SparseVec(t("docs_lexical_idx"), t("docs_lexical_val")))


def mixed_pool(seg) -> tpool.SegmentPool:
    return tpool.SegmentPool(groups=[seg.map(lambda t: t[lo:hi]) for lo, hi in POOL_GROUPS])


# -- cases ------------------------------------------------------------------


def case_helpers(mesh, inp, out) -> None:
    out["helpers"] = np.asarray([mesh_dp_size(mesh), mesh_model_size(mesh),
                                 tdist.mesh_segment_count(mesh)])


def case_search(mesh, inp, out) -> None:
    for dtype in ("float32", "int8"):
        block = tdist.place_segmented_index(load_seg(inp, f"seg_{dtype}"), mesh)
        res = tdist.make_distributed_search_padded(mesh, params(dtype))(block,
                                                                        *load_args(inp, "args"))
        for f in ("ids", "scores", "path_scores", "expanded"):
            out[f"search_{dtype}_{f}"] = getattr(res, f).numpy()
        out[f"search_{dtype}_block_gids"] = block.global_ids.numpy()


def case_build(mesh, inp, out) -> None:
    seg = tdist.build_index_sharded(corpus_rows(inp, 0, int(inp["n_docs"])), N_SEG, T_CFG,
                                    mesh=mesh, draws=[load_draws(inp, s) for s in range(N_SEG)])
    save_seg(out, "build", seg)


def case_descent(mesh, inp, out) -> None:
    t = lambda k: torch.as_tensor(inp[k])
    corpus = FusedVectors(t("round_dense"), SparseVec(t("round_learned_idx"),
                                                      t("round_learned_val")),
                          SparseVec(t("round_lexical_idx"), t("round_lexical_val")))
    ids, sc = tdist.make_distributed_descent_round(mesh, T_CFG.knn)(
        corpus, t("round_nbr"), t("round_scores"), t("round_rand"))
    out["round_ids"], out["round_scores"] = ids.numpy(), sc.numpy()


def case_placement(mesh, inp, out) -> None:
    pool = mixed_pool(load_seg(inp, "seg_float32"))
    pls = tpool.pool_placement(pool, mesh)
    out["placement"] = np.asarray([[p.group, p.n_segments, p.capacity, int(p.sharded)]
                                   for p in pls])
    for p in pls:
        out[f"placement_devices{p.group}"] = np.asarray(p.devices)
    placed = tpool.place_pool(pool, mesh)
    for g, grp in enumerate(placed.groups):
        out[f"placed{g}_gids"] = grp.global_ids.numpy()
        out[f"placed{g}_alive"] = grp.index.alive.numpy()


def case_serve(mesh, inp, out) -> None:
    seg = load_seg(inp, "seg_float32")
    queries, _, kw, _ = load_args(inp, "args")
    for name, index in (("seg", seg), ("pool", mixed_pool(seg))):
        if dist.get_rank() != 0:
            out[f"serve_{name}_followed"] = np.asarray(follow(mesh))
            continue
        with HybridSearchService(index, params("float32"), mesh=mesh) as svc:
            res = svc.search(queries, specs(), keywords=kw.numpy())
        out[f"serve_{name}_ids"], out[f"serve_{name}_scores"] = res.ids.numpy(), res.scores.numpy()
        out[f"serve_{name}_batches"] = np.asarray(svc.stats.batches)


def router_session(mesh, inp, out: dict) -> None:
    """The router's writes and full compaction, then a read (``mesh`` None:
    the same on one process). Returns through ``out``."""
    from repro_torch.serving.segment_router import RouterConfig, SegmentRouter

    pool = tpool.SegmentPool(groups=[])
    for i, (lo, hi) in enumerate(R_SEALED):
        seg = tpool.build_pool_segment(corpus_rows(inp, lo, hi), np.arange(lo, hi), R_BUILD,
                                 capacity=64, generator=torch.Generator().manual_seed(i),
                                 device="cpu")
        pool, _ = tpool.append_segment(pool, seg)
    with HybridSearchService(pool, R_SEARCH, mesh=mesh) as svc:
        router = SegmentRouter(svc, R_BUILD, RouterConfig(auto_compact=False, auto_merge=False))
        router.insert(corpus_rows(inp, *R_INSERT))
        router.delete(R_DELETE)
        if mesh is None:
            router.seal_and_compact(generator=torch.Generator().manual_seed(R_SEED))
        else:
            router.seal_and_compact(seed=R_SEED)
        published = svc.index
        q = corpus_rows(inp, 0, 8)
        res = svc.search(q, FusionSpec.three_path())
    out["router_ids"], out["router_scores"] = res.ids.numpy(), res.scores.numpy()
    out["router_groups"] = np.asarray([g.n_segments for g in published.groups])
    out["router_gids"] = np.sort(np.concatenate([g.global_ids.numpy().ravel()
                                                 for g in published.groups]))
    save_seg(out, "router_group", published.groups[0])


def case_router(mesh, inp, out) -> None:
    if dist.get_rank() == 0:
        router_session(mesh, inp, out)
    else:
        out["router_followed"] = np.asarray(follow(mesh))


def ingest_pipeline():
    from repro_torch.data.textcorpus import load_bundled_corpus
    from repro_torch.ingest.pipeline import IngestConfig, IngestPipeline

    pipe = IngestPipeline(IngestConfig(d_dense=INGEST_DENSE), device="cpu")
    return pipe, pipe.fit(load_bundled_corpus().texts)


def case_ingest(mesh, inp, out) -> None:
    pipe, ingested = ingest_pipeline()
    seg = pipe.build_sharded(ingested, INGEST_SEGMENTS, T_CFG, mesh=mesh, seed=INGEST_SEED)
    save_seg(out, "ingest", seg)


def case_refusals(mesh, inp, out) -> None:
    """What must raise rather than fall back: a mesh of another world size,
    a cuda mesh on this machine (no CUDA; over gloo besides), a tensor of
    another device type in a collective, a descent round given more than
    one segment a device, a service off rank 0."""
    from repro_torch.launch.mesh import all_gather_cat, axis_group

    seg = load_seg(inp, "seg_float32")
    tries = [
        lambda: make_mesh((2 * dist.get_world_size(),), ("data",), device_type="cpu"),
        lambda: make_mesh((dist.get_world_size(),), ("data",), device_type="cuda"),
        lambda: all_gather_cat(mesh, torch.zeros(2, device="meta"), axis_group(mesh, ("data",))),
        # two segments a device: repro's round silently returns one of them
        lambda: tdist.make_distributed_descent_round(mesh, T_CFG.knn)(
            load_seg(inp, "seg_float32").index.corpus, *(torch.zeros(
                (2 * dist.get_world_size(), 4, 2), dtype=dt) for dt in
                (torch.int32, torch.float32, torch.int32))),
    ]
    if dist.get_rank() != 0:
        tries.append(lambda: HybridSearchService(seg, params("float32"), mesh=mesh))
    raised = []
    for fn in tries:
        try:
            fn()
            raised.append(0)
        except (RuntimeError, ValueError):
            raised.append(1)
    out["refusals"] = np.asarray(raised)


def case_orphan(mesh, inp, out) -> None:
    """The controller dies without announcing the end: its follower raises
    (within the mesh's timeout) instead of hanging."""
    import os
    import time

    if dist.get_rank() == 0:
        HybridSearchService(load_seg(inp, "seg_float32"), params("float32"), mesh=mesh)
        os._exit(0)  # no stop_followers, no process-group teardown
    t0 = time.monotonic()
    try:
        follow(mesh)
        out["orphan_raised"] = np.asarray(0)
    except RuntimeError:
        out["orphan_raised"] = np.asarray(1)
    out["orphan_seconds"] = np.asarray(time.monotonic() - t0)


CASES = {"helpers": case_helpers, "search": case_search, "build": case_build,
         "descent": case_descent, "placement": case_placement, "serve": case_serve,
         "router": case_router, "ingest": case_ingest, "refusals": case_refusals,
         "orphan": case_orphan}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("cases")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--axes", required=True)
    ap.add_argument("--store", required=True)
    ap.add_argument("--dir", required=True)
    ap.add_argument("--timeout", type=float, default=60.0)
    a = ap.parse_args(argv)
    torch.set_num_threads(1)
    d = pathlib.Path(a.dir)
    try:
        mesh = make_mesh([int(x) for x in a.shape.split(",")], a.axes.split(","),
                         device_type="cpu", store=dist.FileStore(a.store, a.world),
                         rank=a.rank, world_size=a.world, timeout_s=a.timeout)
        inp = dict(np.load(d / "inputs.npz"))
        out: dict = {}
        for case in a.cases.split(","):
            CASES[case](mesh, inp, out)
        np.savez(d / f"rank{a.rank}.npz", **out)
        if "orphan" not in a.cases:  # an orphan's group has lost its peer
            dist.destroy_process_group()
    except Exception:  # noqa: BLE001 - the test reads the traceback from the file
        (d / f"rank{a.rank}.err").write_text(traceback.format_exc())
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
