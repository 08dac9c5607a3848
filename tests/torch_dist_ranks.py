"""One rank of the port's mesh tests (the index side's, the LM training
side's and its serving side's), on the CPU under gloo.

    python -m tests.torch_dist_ranks CASE[,CASE...] --rank R --world W \\
        --shape 2,2,2 --axes pod,data,model --store FILE --dir DIR

``tests/test_torch_distributed.py``, ``tests/test_torch_lm_mesh.py`` and
``tests/test_torch_lm_serve_mesh.py`` spawn one process per rank (repo root as the working directory, ``src`` on
``PYTHONPATH``); each reads
``DIR/inputs.npz``, which the test wrote from repro's arrays, runs the cases
in order (``CASE:ARG`` passes ARG) and writes ``DIR/rank{R}.npz``. Imports torch and repro_torch
only. Every collective has the mesh's timeout, so a rank left alone raises
instead of hanging.
"""

from __future__ import annotations

import argparse
import contextlib
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


# -- the LM's training side ---------------------------------------------------

LM_STEPS, LM_BATCH, LM_SEQ = 2, 8, 32
LM_OPT = dict(lr=3e-4, warmup_steps=2, total_steps=10)
LM_ROUTER_SCALE = 10.0  # decisive routing where torch and XLA round near-ties apart
LM_CASES = {  # name: (arch, smoke-config overrides at fp32, microbatches)
    "llama": ("llama3.2-1b", {}, 1),
    "llama_mb2": ("llama3.2-1b", {}, 2),
    "llama_fsdp": ("llama3.2-1b", {"fsdp": True, "remat": "full"}, 1),
    "llama_fsdp_mb2": ("llama3.2-1b", {"fsdp": True}, 2),
    "dsv3": ("deepseek-v3-671b", {}, 1),  # capacity 1.25: drops on
    "dsv3_mb2": ("deepseek-v3-671b", {}, 2),
    "rwkv": ("rwkv6-7b", {}, 1),
    "zamba": ("zamba2-1.2b", {}, 1),
    "vlm": ("llama-3.2-vision-90b", {}, 1),
    "whisper": ("whisper-large-v3", {}, 1),
}
# tests/ep_check.py's settings: kimi-k2's smoke config at 8 experts, a
# capacity factor with no drops; with drops, the default factor at 1.0
EP_ARCH, EP_CFG, EP_TOKENS = "kimi-k2-1t-a32b", dict(capacity_factor=8.0, n_experts=8), (8, 16)
EP_DROP_FACTOR = 1.0
CMP_LEAVES = {"a": (64, 48), "b": (8,), "c": (5, 7, 3)}  # compressed_psum_mean's grads
_STATES: dict = {}  # the last train state of each step case, for the checkpoint cases
CKPT_DIR: list = []  # set by main: the directory the checkpoint cases share
CKPT_WAIT_S = 90.0


def lm_config(name: str):
    from repro_torch.configs import get_smoke_config

    arch, kw, mb = LM_CASES[name]
    return dataclasses.replace(get_smoke_config(arch), dtype="float32", **kw), mb


def flatten_tree(tree, prefix: str, out: dict) -> dict:
    for key, sub in tree.items():
        if isinstance(sub, dict):
            flatten_tree(sub, f"{prefix}/{key}", out)
        else:  # a copy: a CPU tensor's numpy view changes with the next step
            out[f"{prefix}/{key}"] = np.array(sub)
    return out


def unflatten_tree(inp, prefix: str) -> dict:
    tree: dict = {}
    for key in inp:
        if key.startswith(prefix + "/"):
            node = tree
            parts = key[len(prefix) + 1:].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = inp[key]
    return tree


def lm_batch(inp, name: str, s: int) -> dict:
    batch = {"tokens": torch.as_tensor(inp["lm_tokens"][s])}
    if f"{name}_frontend" in inp:
        batch["frontend"] = torch.as_tensor(inp[f"{name}_frontend"][s])
    return batch


def placed_state(cfg, mesh, tree):
    """repro's parameters (a flat npz tree), zero moments, placed on the mesh."""
    from repro_torch.convert import model_params_from_numpy
    from repro_torch.launch.sharding import place_state
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_loop import mesh_sharding

    model = model_params_from_numpy(cfg, tree, "cpu")
    state = {"params": model, "opt": opt.init_opt_state(dict(model.named_parameters()),
                                                        opt.OptConfig(**LM_OPT))}
    return place_state(state, mesh_sharding(cfg, mesh))


def save_whole(mesh, state, prefix: str, out: dict) -> None:
    """The state gathered whole (collective); rank 0 writes repro's tree."""
    from repro_torch.convert import train_state_to_numpy
    from repro_torch.launch.sharding import gather_state

    sh = state["params"].placement
    whole = gather_state({"params": state["params"], "opt": state["opt"]}, sh.tree_specs(), mesh)
    if dist.get_rank() == 0:
        flatten_tree(train_state_to_numpy(whole), prefix, out)


def split_as_specs(state) -> int:
    """Leaves (parameters and both moments) whose block is smaller than the
    whole, after checking every block's shape against its spec."""
    from repro_torch.launch.sharding import local_shape
    from repro_torch.models.transformer import Transformer

    sh = state["params"].placement
    whole = dict(Transformer(state["params"].cfg, torch.device("meta")).named_parameters())
    n = 0
    for name, p in state["params"].named_parameters():
        want = local_shape(whole[name].shape, sh.specs[name], sh.mesh)
        for t in (p, state["opt"]["m"][name], state["opt"]["v"][name]):
            if tuple(t.shape) != want:
                raise AssertionError(f"{name}: block {tuple(t.shape)}, its spec gives {want}")
        n += 3 * (want != tuple(whole[name].shape))
    return n


def case_lmstep(mesh, inp, out, name: str, compressed: str = "") -> None:
    """LM_STEPS mesh steps of case ``name`` from repro's parameters; the
    losses, grad norms, the number of split leaves and (rank 0) the whole
    state after each step."""
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_loop import TrainConfig, make_train_step, mesh_sharding

    cfg, mb = lm_config(name)
    tcfg = TrainConfig(opt=opt.OptConfig(**LM_OPT), microbatches=mb,
                       grad_compression=bool(compressed))
    state = placed_state(cfg, mesh, unflatten_tree(inp, f"{name}_params"))
    tag = name + ("_cmp" if compressed else "")
    out[f"{tag}_split"] = np.asarray(split_as_specs(state))
    step = make_train_step(cfg, tcfg, mesh, mesh_sharding(cfg, mesh).specs)
    losses, norms = [], []
    for s in range(LM_STEPS):
        if compressed:
            save_block_grads(mesh, state, step, lm_batch(inp, name, s), f"{tag}_raw{s}", out)
        state, met = step(state, lm_batch(inp, name, s))
        if compressed:
            save_dp_blocks(mesh, state, state["residual"], f"{tag}_res{s}", out)
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
        save_whole(mesh, state, f"{tag}_state{s + 1}", out)
    out[f"{tag}_loss"], out[f"{tag}_gnorm"] = np.asarray(losses), np.asarray(norms)
    _STATES[tag] = state


@contextlib.contextmanager
def float64_compute():
    """Inside, the port's model functions compute in float64: ``dtype_of``
    gives float64, new tensors default to it, and ``Tensor.float()`` (the
    model's upcast of bf16 for its float32 arithmetic) keeps a float64
    tensor as it is."""
    mods = [m for n, m in list(sys.modules.items())
            if n.startswith("repro_torch") and hasattr(m, "dtype_of")]
    saved = [(m, m.dtype_of) for m in mods]
    as_float, default = torch.Tensor.float, torch.get_default_dtype()
    torch.Tensor.float = lambda t, *a, **k: t if t.dtype == torch.float64 else as_float(t, *a, **k)
    torch.set_default_dtype(torch.float64)
    for m in mods:
        m.dtype_of = lambda cfg: torch.float64
    try:
        yield
    finally:
        torch.Tensor.float = as_float
        torch.set_default_dtype(default)
        for m, fn in saved:
            m.dtype_of = fn


def case_lmstep64(mesh, inp, out, name: str) -> None:
    """One mesh step of case ``name`` and the one-device step, both in
    float64 from repro's parameters on the first batch; (rank 0) the
    largest |difference| of the first moment, relative to each leaf's
    largest, over the leaves."""
    from repro_torch.convert import model_params_from_numpy
    from repro_torch.launch.sharding import gather_state, place_state
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_loop import TrainConfig, make_train_step, mesh_sharding

    cfg, mb = lm_config(name)
    tcfg = TrainConfig(opt=opt.OptConfig(**LM_OPT), microbatches=mb)
    with float64_compute():
        def state():
            model = model_params_from_numpy(cfg, unflatten_tree(inp, f"{name}_params"), "cpu")
            for p in model.parameters():
                p.data = p.data.double()
            o = opt.init_opt_state(dict(model.named_parameters()), tcfg.opt)
            for k in ("m", "v"):
                o[k] = {n: t.double() for n, t in o[k].items()}
            return {"params": model, "opt": o}

        one, _ = make_train_step(cfg, tcfg)(state(), lm_batch(inp, name, 0))
        sh = mesh_sharding(cfg, mesh)
        st, _ = make_train_step(cfg, tcfg, mesh, sh.specs)(place_state(state(), sh),
                                                           lm_batch(inp, name, 0))
        whole = gather_state({"params": st["params"], "opt": st["opt"]},
                             st["params"].placement.tree_specs(), mesh)
    if dist.get_rank() == 0:
        gaps = [float((whole["opt"]["m"][k] - w).abs().max() / w.abs().max().clamp_min(1e-300))
                for k, w in one["opt"]["m"].items()]
        out[f"{name}_m64_gap"] = np.asarray(max(gaps))


def save_block_grads(mesh, state, step, batch, prefix: str, out: dict) -> None:
    """The compressed mode's gradients of this data-parallel rank's block
    before the mean, and its loss (see ``save_dp_blocks``)."""
    loss, grads = step.raw_grads(state, batch)
    save_dp_blocks(mesh, state, grads, prefix, out, loss=loss)


def save_dp_blocks(mesh, state, tree: dict, prefix: str, out: dict, loss=None) -> None:
    """{name: this rank's tensor} gathered over the model axis, written by
    the ranks at model index 0 under the rank's data-parallel index."""
    from repro_torch.launch.mesh import axis_group
    from repro_torch.launch.sharding import gather_state

    specs = state["params"].placement.specs
    model_only = {k: tuple(e if e == "model" else None for e in sp) for k, sp in specs.items()}
    whole = gather_state(tree, model_only, mesh)
    model = axis_group(mesh, ("model",))
    if model is None or model.index == 0:
        r = axis_group(mesh, ("pod", "data")).index
        if loss is not None:
            out[f"{prefix}_loss{r}"] = np.asarray(float(loss))
        for k, g in whole.items():
            out[f"{prefix}_{r}/{k}"] = g.numpy()


def case_cmp(mesh, inp, out) -> None:
    """compressed_psum_mean over the data-parallel axes, each rank's grads
    and residual those of its data-parallel index."""
    from repro_torch.launch.mesh import axis_group
    from repro_torch.training.grad_compression import compressed_payload, compressed_psum_mean

    r = axis_group(mesh, ("pod", "data")).index
    grads = {k: torch.as_tensor(inp[f"cmp_g_{k}"][r]) for k in CMP_LEAVES}
    res = {k: torch.as_tensor(inp[f"cmp_r_{k}"][r]) for k in CMP_LEAVES}
    q_sum, _, _, _ = compressed_payload(grads, ("pod", "data"), res, mesh)
    mean, new_res = compressed_psum_mean(grads, ("pod", "data"), res, mesh)
    out["cmp_q_sum"] = q_sum.numpy()
    for k in CMP_LEAVES:
        out[f"cmp_mean_{k}"], out[f"cmp_res_{k}"] = mean[k].numpy(), new_res[k].numpy()


def ep_config(drops: bool):
    from repro_torch.configs import get_smoke_config

    cfg = dataclasses.replace(get_smoke_config(EP_ARCH), dtype="float32", **EP_CFG)
    return dataclasses.replace(cfg, capacity_factor=EP_DROP_FACTOR) if drops else cfg


def whole_logits(mesh, cfg, state, tokens):
    """The forward's logits of the global batch on the mesh, gathered whole
    (vocab over the model axis, rows over the data-parallel axes)."""
    from repro_torch.launch.mesh import axis_group
    from repro_torch.launch.sharding import all_gather, dp_block
    from repro_torch.models import parallel as par
    from repro_torch.models import transformer as tfm
    from repro_torch.training.train_loop import mesh_model

    with torch.no_grad(), mesh_model(state["params"], mesh, global_dp=True):
        logits, aux, _ = tfm.make_forward(cfg)(state["params"], dp_block(tokens, mesh))
        tp = par.tp_group(state["params"].embed, "tok")
        logits = logits if tp is None else par.gather_vocab(logits, tp)
    return all_gather(logits, axis_group(mesh, ("pod", "data")), mesh, 0), aux


def case_ep(mesh, inp, out) -> None:
    """kimi-k2's smoke config at ep_check's settings on the mesh, gspmd and
    ep_manual: the whole logits, the aux losses, and (rank 0) the whole
    gradients with the aux loss off; then ep_manual with drops."""
    from repro_torch.launch.sharding import gather_state
    from repro_torch.models import transformer as tfm
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_loop import TrainConfig, make_train_step

    tokens = torch.as_tensor(inp["ep_tokens"])
    coef = tfm.AUX_LOSS_COEF
    for drops in (False, True):
        for impl in ("gspmd", "ep_manual"):
            if drops and impl == "gspmd":
                continue
            cfg = dataclasses.replace(ep_config(drops), moe_impl=impl)
            tag = f"ep_{impl}" + ("_drops" if drops else "")
            state = placed_state(cfg, mesh, unflatten_tree(inp, "ep_params"))
            logits, aux = whole_logits(mesh, cfg, state, tokens)
            out[f"{tag}_logits"], out[f"{tag}_aux"] = logits.numpy(), np.asarray(float(aux))
            if drops:
                continue
            step = make_train_step(cfg, TrainConfig(opt=opt.OptConfig(**LM_OPT)), mesh)
            tfm.AUX_LOSS_COEF = 0.0
            try:
                _, grads = step.grads(state, {"tokens": tokens})
            finally:
                tfm.AUX_LOSS_COEF = coef
            sh = state["params"].placement
            whole = gather_state(grads, sh.specs, mesh)
            if dist.get_rank() == 0:
                for k, g in whole.items():
                    out[f"{tag}_grad/{k}"] = g.numpy()


def case_ckpt_save(mesh, inp, out) -> None:
    """The llama case's state after its steps, saved on this mesh."""
    from repro_torch.checkpoint import save_checkpoint

    save_checkpoint(CKPT_DIR[0], LM_STEPS, _STATES["llama"])


def case_ckpt_restore(mesh, inp, out) -> None:
    """That checkpoint (waited for: the saving world runs beside this one)
    restored onto this mesh (a target of another shape), then gathered
    whole."""
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_loop import TrainConfig, make_train_state

    import time

    from repro_torch.checkpoint import latest_step

    cfg, _ = lm_config("llama")
    target = make_train_state(cfg, TrainConfig(opt=opt.OptConfig(**LM_OPT)),
                              torch.Generator().manual_seed(5), "cpu", mesh=mesh)
    deadline = time.monotonic() + CKPT_WAIT_S  # the saving world runs beside this one
    while latest_step(CKPT_DIR[0]) != LM_STEPS:
        if time.monotonic() > deadline:
            raise TimeoutError(f"no checkpoint of step {LM_STEPS} in {CKPT_DIR[0]}")
        time.sleep(0.2)
    state = restore_checkpoint(CKPT_DIR[0], LM_STEPS, target)
    out["ckpt_split"] = np.asarray(split_as_specs(state))
    save_whole(mesh, state, "ckpt_state", out)


def case_roundtrip(mesh, inp, out) -> None:
    """shard_state then gather_state gives back every config's whole state."""
    from repro_torch.launch.sharding import gather_state, shard_state
    from repro_torch.training.train_loop import TrainConfig, make_train_state, mesh_sharding

    same = []
    for name in ("llama_fsdp", "dsv3", "rwkv", "zamba", "vlm", "whisper"):
        cfg, _ = lm_config(name)
        whole = make_train_state(cfg, TrainConfig(), torch.Generator().manual_seed(1), "cpu")
        for t in whole["opt"]["m"].values():
            t.normal_(generator=torch.Generator().manual_seed(2))
        ref = {n: p.detach().clone() for n, p in whole["params"].named_parameters()}
        ref_m = {n: t.clone() for n, t in whole["opt"]["m"].items()}
        specs = mesh_sharding(cfg, mesh).tree_specs()
        back = gather_state(shard_state(whole, specs, mesh), specs, mesh)
        same.append(all(torch.equal(p, ref[n]) for n, p in back["params"].named_parameters())
                    and all(torch.equal(t, ref_m[n]) for n, t in back["opt"]["m"].items()))
    out["roundtrip"] = np.asarray(same)


def case_lm_refusals(mesh, inp, out) -> None:
    """What must raise on the LM side: a mesh of another world size, a
    spec'd dim its axis does not divide, a tensor of another device type, a
    mesh that is not a DeviceMesh, a state not placed on the mesh, ep_manual
    and the compressed mean off a mesh, and on the mesh a cached decode
    given no cache specs (``ServingEngine(mesh=)`` gives them)."""
    from repro_torch.launch.sharding import shard_state
    from repro_torch.models import transformer as tfm
    from repro_torch.models.moe import apply_moe_ep
    from repro_torch.training import optimizer as opt
    from repro_torch.training.grad_compression import compressed_psum_mean
    from repro_torch.training.train_loop import (TrainConfig, make_train_state, make_train_step,
                                                 mesh_model)

    cfg, _ = lm_config("llama")
    tcfg = TrainConfig(opt=opt.OptConfig(**LM_OPT))
    one = make_train_state(cfg, tcfg, torch.Generator().manual_seed(0), "cpu")
    placed = make_train_state(cfg, tcfg, torch.Generator().manual_seed(0), "cpu", mesh=mesh)
    tokens = {"tokens": torch.zeros((LM_BATCH, 4), dtype=torch.int32)}

    def on_mesh(fn):
        with mesh_model(placed["params"], mesh, global_dp=True):
            fn()

    cache = {g: tfm._zero_state(spec, "cpu") for g, spec in tfm.cache_shape(cfg, 2, 8).items()}
    tries = [
        lambda: make_mesh((2 * dist.get_world_size(), 1, 1), ("pod", "data", "model"),
                          device_type="cpu"),
        lambda: shard_state({"w": torch.zeros(3)}, {"w": ("model",)}, mesh),
        lambda: shard_state({"w": torch.zeros(4, device="meta")}, {"w": ("model",)}, mesh),
        lambda: make_train_step(cfg, tcfg, mesh=object()),
        lambda: make_train_step(cfg, tcfg, mesh)(one, tokens),
        lambda: apply_moe_ep(None, ep_config(False), torch.zeros(1, 2, 4)),
        lambda: compressed_psum_mean({"w": torch.zeros(2)}, ("data",)),
        lambda: on_mesh(lambda: tfm.make_decode_step(cfg)(
            placed["params"], torch.zeros(2, dtype=torch.int32), cache, 0)),
    ]
    raised = []
    for fn in tries:
        try:
            fn()
            raised.append(0)
        except NotImplementedError:
            raised.append(2)
        except (RuntimeError, ValueError, TypeError):
            raised.append(1)
    out["lm_refusals"] = np.asarray(raised)


# -- the LM's serving side ------------------------------------------------------

SERVE_CASES = {  # name: (arch, smoke-config overrides at fp32, batch, prompt, new tokens, max_len)
    "llama": ("llama3.2-1b", {}, 8, 6, 4, 16),
    "llama_odd": ("llama3.2-1b", {}, 6, 6, 4, 16),  # rows the data-parallel axes do not divide
    "llama_rep": ("llama3.2-1b", {}, 4, 6, 4, 18),  # 18 positions: no split of the KV cache
    "edge": ("llama3.2-1b", {}, 4, 2, 9, 16),  # decode at 2..9: inside, on and past the blocks
    "dsv3": ("deepseek-v3-671b", {}, 8, 6, 4, 16),
    "dsv3_lat": ("deepseek-v3-671b", {}, 4, 6, 4, 18),  # the latent split over its last dim
    "dsv3_ep": ("deepseek-v3-671b", {"moe_impl": "ep_manual", "capacity_factor": 8.0}, 8, 6, 4,
                16),
    "rwkv": ("rwkv6-7b", {}, 8, 16, 4, 32),  # 16 positions: the chunked prefill
    "rwkv_hd64": ("rwkv6-7b", {"ssm_head_dim": 64}, 4, 6, 4, 16),  # 2 heads: columns off heads
    "zamba": ("zamba2-1.2b", {}, 8, 16, 4, 32),
    "vlm": ("llama-3.2-vision-90b", {}, 8, 6, 4, 16),
    "whisper": ("whisper-large-v3", {}, 8, 6, 4, 16),
    "whisper_kv2": ("whisper-large-v3", {"n_kv_heads": 2}, 4, 6, 4, 16),
}


def serve_config(name: str):
    from repro_torch.configs import get_smoke_config

    arch, kw, b, lp, n, max_len = SERVE_CASES[name]
    return dataclasses.replace(get_smoke_config(arch), dtype="float32", **kw), b, lp, n, max_len


def case_serve_lm(mesh, inp, out, name: str) -> None:
    """``ServingEngine(mesh=)`` on case ``name`` from repro's parameters and
    prompts: the tokens, the whole logits every step sampled from, and this
    rank's blocks of the cache after prefill (and their shapes' placement
    by ``cache_shardings``; gathered whole and cut again, the same blocks)."""
    from repro_torch.convert import model_params_from_numpy
    from repro_torch.launch.sharding import gather_cache, place_model, shard_cache
    from repro_torch.serving.engine import ServeConfig, ServingEngine, cache_shardings
    from repro_torch.training.train_loop import mesh_sharding

    cfg, b, lp, n, max_len = serve_config(name)
    model = place_model(model_params_from_numpy(cfg, unflatten_tree(inp, f"serve_{name}_params"),
                                                "cpu"), mesh_sharding(cfg, mesh))
    eng = ServingEngine(cfg, model, ServeConfig(max_len=max_len, batch=b), mesh=mesh)
    seen, sample, prefill = [], eng._sample, eng._prefill

    def record(logits, generator):
        seen.append(logits.clone())
        return sample(logits, generator)

    shards = cache_shardings(cfg, mesh, b, max_len)

    def caught(*args):
        logits, cache = prefill(*args)
        flatten_tree({g: {k: t.clone() for k, t in tree.items()} for g, tree in cache.items()},
                     f"serve_{name}_cache", out)
        back = shard_cache(gather_cache(cache, shards), shards)
        out[f"serve_{name}_roundtrip"] = np.asarray(all(
            torch.equal(back[g][k], t) for g, tree in cache.items() for k, t in tree.items()))
        return logits, cache

    eng._sample, eng._prefill = record, caught
    fe = inp.get(f"serve_{name}_frontend")
    toks = eng.generate(torch.as_tensor(inp[f"serve_{name}_prompts"]), n,
                        frontend=None if fe is None else torch.as_tensor(fe))
    out[f"serve_{name}_tokens"] = toks.numpy()
    out[f"serve_{name}_logits"] = torch.stack(seen).numpy()
    from repro_torch.models.transformer import cache_shape

    for g, tree in cache_shape(cfg, b, max_len).items():
        for k, spec in tree.items():
            out[f"serve_{name}_shard/{g}/{k}"] = np.asarray(shards[g][k].shard_shape(spec.shape))


CASES = {"helpers": case_helpers, "search": case_search, "build": case_build,
         "descent": case_descent, "placement": case_placement, "serve": case_serve,
         "router": case_router, "ingest": case_ingest, "refusals": case_refusals,
         "orphan": case_orphan, "lmstep": case_lmstep, "lmstep64": case_lmstep64,
         "cmp": case_cmp, "ep": case_ep,
         "ckpt_save": case_ckpt_save, "ckpt_restore": case_ckpt_restore,
         "roundtrip": case_roundtrip, "lm_refusals": case_lm_refusals,
         "serve_lm": case_serve_lm}


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
        CKPT_DIR[:] = [d.parent / "ckpt"]
        out: dict = {}
        for case in a.cases.split(","):
            name, *args = case.split(":")
            CASES[name](mesh, inp, out, *args)
        np.savez(d / f"rank{a.rank}.npz", **out)
        if "orphan" not in a.cases:  # an orphan's group has lost its peer
            dist.destroy_process_group()
    except Exception:  # noqa: BLE001 - the test reads the traceback from the file
        (d / f"rank{a.rank}.err").write_text(traceback.format_exc())
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
