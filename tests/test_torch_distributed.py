"""The port's index side over a device mesh, on CPU ranks under gloo, against
repro on a one-device mesh in this process: the mesh helpers; the sharded
search (worlds 4 ``("data",)`` and 8 ``(2, 2, 2)``) over a repro-built index
of 8 segments in all four fusion modes, keywords on, fp32 and int8; the
sharded build (worlds 2 and 4) against the sequential build under the same
draws, bit for bit, and against repro's under repro's draws; the descent
round; pool placement; the mesh-fronted service over a ``SegmentedIndex``
and a mixed pool, and its shutdown; the router's full compaction; the
ingest pipeline's sharded build; what must raise instead of falling back;
and a follower whose controller died.

Each world is one spawned run of ``tests/torch_dist_ranks.py`` (processes
that import torch and repro_torch only), joined under a limit of its own;
the tests read what its ranks wrote. Ids exact, scores and path scores at
``test_torch_pool.py``'s tolerance, ``expanded`` exact."""

from __future__ import annotations

import dataclasses
import os
import pathlib
import subprocess
import sys
import time
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import FusionSpec as RFusionSpec  # noqa: E402
from repro.core import distributed as rdist  # noqa: E402
from repro.core import segment_pool as rpool  # noqa: E402
from repro.core.build_pipeline import build_graph as r_build_graph  # noqa: E402
from repro.core.fusion import merge_fused_host as r_merge_fused_host  # noqa: E402
from repro.core.knn_graph import _descent_round_chunk as r_descent_round_chunk  # noqa: E402
from repro.core.search import SearchParams as RSearchParams  # noqa: E402
from repro.data.corpus import CorpusConfig, make_corpus  # noqa: E402
from repro.launch import mesh as rmesh  # noqa: E402
from repro_torch.convert import segmented_from_arrays  # noqa: E402
from repro_torch.core import distributed as tdist  # noqa: E402
from repro_torch.core.fusion import stack_specs  # noqa: E402
from repro_torch.core.knn_graph import _descent_round_chunk  # noqa: E402
from repro_torch.serving.hybrid_service import HybridSearchService, _flat_args  # noqa: E402
from tests import torch_dist_ranks as ranks  # noqa: E402
from tests.test_torch_build import repro_draws, rows_equal_as_sets  # noqa: E402
from tests.test_torch_pool import R_CFG as POOL_R_CFG  # noqa: E402
from tests.test_torch_pool import TOL, assert_group_matches, to_torch  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
R_CFG = dataclasses.replace(POOL_R_CFG, knn=dataclasses.replace(POOL_R_CFG.knn, **ranks.KNN),
                            prune=dataclasses.replace(POOL_R_CFG.prune, **ranks.PRUNE))
KEY = jax.random.key(7)
N_DOCS, B = 512, 8
SPAWN_LIMIT_S = 100.0  # each world's ranks, joined


def stub_mesh(shape: dict):
    """What repro's mesh helpers read of a mesh: axis names and sizes."""
    return types.SimpleNamespace(axis_names=tuple(shape), shape=dict(shape))


WORLDS = {  # world: (shape, axes, cases)
    2: ("2", "data", "helpers,build,descent,placement,router,ingest,refusals"),
    4: ("4", "data", "helpers,search,build,serve"),
    8: ("2,2,2", "pod,data,model", "helpers,search"),
}
STUB = {2: {"data": 2}, 4: {"data": 4}, 8: {"pod": 2, "data": 2, "model": 2}}


def start(d: pathlib.Path, world: int, shape: str, axes: str, cases: str,
          timeout_s: float = 60.0):
    """Start the ranks of ``world`` over ``d/inputs.npz`` (``join`` waits)."""
    env = dict(os.environ, PYTHONPATH=f"{REPO / 'src'}:{REPO}", OMP_NUM_THREADS="1")
    store = d / f"store{world}_{cases.replace(',', '_').replace(':', '_')}"
    procs = []
    for r in range(world):
        log = open(d / f"rank{r}.log", "w")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "tests.torch_dist_ranks", cases, "--rank", str(r), "--world",
             str(world), "--shape", shape, "--axes", axes, "--store", str(store), "--dir",
             str(d), "--timeout", str(timeout_s)], cwd=REPO, env=env, stdout=log,
            stderr=subprocess.STDOUT))
        log.close()
    return d, world, cases, procs, time.monotonic() + SPAWN_LIMIT_S


def join(handle) -> list[dict]:
    """Every rank's outputs of a started world. Fails (killing every rank)
    past ``SPAWN_LIMIT_S`` from its start."""
    d, world, cases, procs, deadline = handle
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pytest.fail(f"world {world} ({cases}) did not end within {SPAWN_LIMIT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    errs = [(d / f"rank{r}.err").read_text() for r in range(world)
            if (d / f"rank{r}.err").exists()]
    assert not errs, "\n".join(errs)
    assert [p.returncode for p in procs] == [0] * world, [
        (d / f"rank{r}.log").read_text() for r in range(world)]
    return [dict(np.load(d / f"rank{r}.npz")) for r in range(world)]


def spawn(d: pathlib.Path, world: int, shape: str, axes: str, cases: str,
          timeout_s: float = 60.0) -> list[dict]:
    """Run the ranks of ``world`` over ``d/inputs.npz``; every rank's outputs."""
    return join(start(d, world, shape, axes, cases, timeout_s))


def save_seg(inp: dict, prefix: str, seg) -> None:
    ranks.save_seg(inp, prefix, seg)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """repro's index, searches, draws and round, and the inputs file."""
    corpus = make_corpus(CorpusConfig(n_docs=N_DOCS, n_queries=B, n_topics=8, d_dense=16,
                                      nnz_sparse=8, nnz_lexical=6, seed=41))
    docs = jax.tree.map(jnp.asarray, corpus.docs)
    r_seg = rdist.build_segmented_index(docs, ranks.N_SEG, R_CFG, key=KEY)
    r_segs = {"float32": r_seg, "int8": dataclasses.replace(r_seg, index=dataclasses.replace(
        r_seg.index, corpus=jax.vmap(rpool.quantize_corpus)(r_seg.index.corpus)))}
    specs_r = [dataclasses.replace(RFusionSpec.make(m, 1.0, 0.6, 0.3 + i / 10),
                                   stats=rdist.PathStats.identity())
               for i, m in enumerate(ranks.MODES)]
    stack_r = jax.tree.map(lambda *xs: jnp.stack(xs), *specs_r)
    kw = np.full((B, 2), -1, np.int32)
    kw[::2, 0] = np.asarray(corpus.docs.lexical.idx)[:B:2, 0]
    ent = np.full((B, 1), -1, np.int32)
    q = jax.tree.map(jnp.asarray, corpus.queries)
    one = jax.make_mesh((1,), ("data",))
    want = {dt: rdist.make_distributed_search_padded(one, RSearchParams(
        use_kernel=False, corpus_dtype=dt, **ranks.SEARCH))(s, q, stack_r, jnp.asarray(kw),
                                                            jnp.asarray(ent))
        for dt, s in r_segs.items()}
    inp = {"n_docs": np.asarray(N_DOCS)}
    for dt, s in r_segs.items():
        save_seg(inp, f"seg_{dt}", segmented_from_arrays(s, "cpu"))
    tq = to_torch(corpus.queries)
    args = (tq, stack_specs(ranks.specs()), torch.as_tensor(kw), torch.as_tensor(ent))
    for j, t in enumerate(_flat_args(args)):
        inp[f"args_{j}"] = t.numpy()
    for name, a in (("dense", corpus.docs.dense), ("learned_idx", corpus.docs.learned.idx),
                    ("learned_val", corpus.docs.learned.val),
                    ("lexical_idx", corpus.docs.lexical.idx),
                    ("lexical_val", corpus.docs.lexical.val)):
        inp[f"docs_{name}"] = np.asarray(a)
    per = N_DOCS // ranks.N_SEG
    draws = [repro_draws(per, R_CFG, jax.random.fold_in(KEY, s)) for s in range(ranks.N_SEG)]
    for s, dr in enumerate(draws):
        inp[f"draws{s}_init"] = dr.init_graph.numpy()
        for i, t in enumerate(dr.rounds):
            inp[f"draws{s}_round{i}"] = t.numpy()
        for p, tables in enumerate(dr.path_rounds):
            for i, t in enumerate(tables):
                inp[f"draws{s}_path{p}_{i}"] = t.numpy()
    # the descent round: two segments' kNN graphs from repro's build stage
    parts = [docs[slice(s * per, (s + 1) * per)] for s in range(2)]
    graphs = [r_build_graph(p, R_CFG, jax.random.fold_in(KEY, s)) for s, p in enumerate(parts)]
    rand = np.random.default_rng(3).integers(0, per, size=(2, per, R_CFG.knn.extra_random))
    rand = rand.astype(np.int32)
    round_want = [r_descent_round_chunk(p, g.knn_ids, p, jnp.arange(per, dtype=jnp.int32),
                                        g.knn_ids, g.knn_scores, jnp.asarray(rand[s]),
                                        R_CFG.knn)
                  for s, (p, g) in enumerate(zip(parts, graphs))]
    for name, get in (("dense", lambda c: c.dense), ("learned_idx", lambda c: c.learned.idx),
                      ("learned_val", lambda c: c.learned.val),
                      ("lexical_idx", lambda c: c.lexical.idx),
                      ("lexical_val", lambda c: c.lexical.val)):
        inp[f"round_{name}"] = np.stack([np.asarray(get(p)) for p in parts])
    inp["round_nbr"] = np.stack([np.asarray(g.knn_ids) for g in graphs])
    inp["round_scores"] = np.stack([np.asarray(g.knn_scores) for g in graphs])
    inp["round_rand"] = rand
    # the mixed pool (groups of 4 and 3 segments) searched by repro's local
    # group search per group, merged on the host as its service merges
    r_pool = rpool.SegmentPool(groups=[jax.tree.map(lambda a: a[lo:hi], r_seg)
                                       for lo, hi in ranks.POOL_GROUPS])
    parts = [rdist.make_local_group_search(RSearchParams(use_kernel=False, **ranks.SEARCH))(
        g, q, stack_r, jnp.asarray(kw), jnp.asarray(ent)) for g in r_pool.groups]
    pool_ids, _, _ = r_merge_fused_host(
        [np.asarray(p.ids) for p in parts], [np.asarray(p.scores) for p in parts],
        [np.asarray(p.path_scores) for p in parts], stack_r, ranks.SEARCH["k"])
    d = tmp_path_factory.mktemp("mesh")
    np.savez(d / "inputs.npz", **inp)
    return types.SimpleNamespace(d=d, inp=inp, want=want, draws=draws, r_seg=r_seg,
                                 r_pool=r_pool, pool_ids=pool_ids, round_want=round_want,
                                 docs=to_torch(corpus.docs))


@pytest.fixture(scope="module")
def worlds(ref):
    """Each world's ranks' outputs, spawned on first use."""
    cache: dict = {}

    def get(world: int) -> list[dict]:
        if world not in cache:
            d = ref.d / f"w{world}"
            d.mkdir()
            (d / "inputs.npz").symlink_to(ref.d / "inputs.npz")
            cache[world] = spawn(d, world, *WORLDS[world])
        return cache[world]

    return get


@pytest.mark.parametrize("world", [2, 4, 8])
def test_mesh_helpers_match_repro(worlds, world):
    m = stub_mesh(STUB[world])
    want = [rmesh.mesh_dp_size(m), rmesh.mesh_model_size(m), rdist.mesh_segment_count(m)]
    for out in worlds(world):
        assert out["helpers"].tolist() == want


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("world", [4, 8])
def test_sharded_search_matches_repro(ref, worlds, world, dtype):
    """Every rank returns the whole batch: repro's ids, scores and path
    scores at TOL, its expanded total."""
    want = ref.want[dtype]
    msc = rdist.mesh_segment_count(stub_mesh(STUB[world]))
    spd = ranks.N_SEG // msc
    gids = np.asarray(ref.r_seg.global_ids)
    for r, out in enumerate(worlds(world)):
        np.testing.assert_array_equal(out[f"search_{dtype}_ids"], np.asarray(want.ids))
        np.testing.assert_allclose(out[f"search_{dtype}_scores"], np.asarray(want.scores),
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(out[f"search_{dtype}_path_scores"],
                                   np.asarray(want.path_scores), rtol=TOL, atol=TOL)
        np.testing.assert_array_equal(out[f"search_{dtype}_expanded"], np.asarray(want.expanded))
        c = r // (world // msc)  # the rank's coordinate on the segment axes
        np.testing.assert_array_equal(out[f"search_{dtype}_block_gids"],
                                      gids[c * spd:(c + 1) * spd])


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_build_matches_sequential_and_repro(ref, worlds, world):
    """Every rank's whole index equals build_segmented_index under the same
    draws bit for bit, and repro's build under repro's draws at
    test_torch_build's tolerance."""
    seq = tdist.build_segmented_index(ref.docs, ranks.N_SEG, ranks.T_CFG, draws=ref.draws,
                                      device="cpu")
    for out in worlds(world):
        got = ranks.load_seg(out, "build")
        for a, b in zip(got.leaves(), seq.leaves()):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert_group_matches(got, ref.r_seg)


def test_descent_round_matches_repro(ref, worlds):
    t = lambda k: torch.as_tensor(ref.inp[k])
    for out in worlds(2):
        for s, (want_ids, want_sc) in enumerate(ref.round_want):
            np.testing.assert_allclose(out["round_scores"][s], np.asarray(want_sc),
                                       rtol=1e-5, atol=1e-5)
            assert rows_equal_as_sets(out["round_ids"][s], want_ids) == 1.0
            corpus = ranks.FusedVectors(
                t("round_dense")[s], ranks.SparseVec(t("round_learned_idx")[s],
                                                     t("round_learned_val")[s]),
                ranks.SparseVec(t("round_lexical_idx")[s], t("round_lexical_val")[s]))
            nbr = t("round_nbr")[s]
            ids, sc = _descent_round_chunk(corpus, nbr, corpus,
                                           torch.arange(nbr.shape[0], dtype=torch.int32), nbr,
                                           t("round_scores")[s], t("round_rand")[s],
                                           ranks.T_CFG.knn)
            np.testing.assert_array_equal(out["round_ids"][s], ids.numpy())
            np.testing.assert_array_equal(out["round_scores"][s], sc.numpy())


def test_pool_placement_matches_repro(ref, worlds):
    """Groups of 4 and 3 segments over two segment devices: the first
    shards, two segments a rank; the second stays whole on rank 0."""
    want = rpool.pool_placement(ref.r_pool, stub_mesh(STUB[2]))
    gids = np.asarray(ref.r_seg.global_ids)
    outs = worlds(2)
    for r, out in enumerate(outs):
        assert out["placement"].tolist() == [[p.group, p.n_segments, p.capacity, int(p.sharded)]
                                             for p in want]
        for p in want:
            assert tuple(out[f"placement_devices{p.group}"].tolist()) == p.devices
        np.testing.assert_array_equal(out["placed0_gids"], gids[2 * r:2 * r + 2])
        np.testing.assert_array_equal(out["placed1_gids"], gids[4:7] if r == 0 else gids[4:4])
    assert [p.sharded for p in want] == [True, False]


@pytest.mark.parametrize("index", ["seg", "pool"])
def test_mesh_service_matches_repro(ref, worlds, index):
    """The mesh-fronted service on world 4 over the SegmentedIndex (every
    read sharded) and over the mixed pool (the group of 4 sharded, the
    group of 3 searched by rank 0 alone) gives repro's ids; closing it ends
    every follower, each having joined the sharded reads."""
    outs = worlds(4)
    want = np.asarray(ref.want["float32"].ids) if index == "seg" else ref.pool_ids
    np.testing.assert_array_equal(outs[0][f"serve_{index}_ids"], want)
    batches = int(outs[0][f"serve_{index}_batches"])
    assert batches >= 1
    for out in outs[1:]:
        assert int(out[f"serve_{index}_followed"]) == batches


def test_segmented_service_needs_a_mesh(ref):
    seg = segmented_from_arrays(ref.r_seg, "cpu")
    with pytest.raises(ValueError, match="requires a mesh"):
        HybridSearchService(seg, ranks.params("float32"))


def test_router_full_compaction_over_mesh(ref, worlds):
    """After the same inserts and deletes, the full compaction over world 2
    (two segments, one a rank) reads as the mesh-less router's one segment:
    the searches score every live doc, so the ids agree."""
    outs = worlds(2)
    want: dict = {}
    ranks.router_session(None, ref.inp, want)
    got = outs[0]
    assert got["router_groups"].tolist() == [2] and want["router_groups"].tolist() == [1]
    live = lambda g: g[g >= 0]
    np.testing.assert_array_equal(live(got["router_gids"]), live(want["router_gids"]))
    np.testing.assert_array_equal(got["router_ids"], want["router_ids"])
    np.testing.assert_allclose(got["router_scores"], want["router_scores"], rtol=TOL, atol=TOL)
    assert int(outs[1]["router_followed"]) >= 1
    # the published group is the sequential build of the same docs under
    # the same seeds: segment s from seed + s
    group = ranks.load_seg(got, "router_group")
    assert group.n_segments == 2 and not bool(group.index.alive[group.global_ids < 0].any())


def test_ingest_build_sharded_over_mesh(worlds):
    """IngestPipeline.build_sharded(mesh=) on world 2 (the bundled corpus,
    with its KG) equals the mesh-less build under the same seed."""
    pipe, ingested = ranks.ingest_pipeline()
    want = pipe.build_sharded(ingested, ranks.INGEST_SEGMENTS, ranks.T_CFG,
                              seed=ranks.INGEST_SEED)
    assert want.index.entity_adj.shape[-1] > 1  # the KG is on the path
    for out in worlds(2):
        got = ranks.load_seg(out, "ingest")
        for a, b in zip(got.leaves(), want.leaves()):
            np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_no_fallback_on_the_mesh(worlds):
    """A mesh of another world size, a cuda mesh here, a tensor of another
    device type in a collective, a descent round over two segments a device
    (repro's returns one of them, ROADMAP Queue 3) and a service off rank 0
    all raise."""
    outs = worlds(2)
    assert outs[0]["refusals"].tolist() == [1, 1, 1, 1]
    assert outs[1]["refusals"].tolist() == [1, 1, 1, 1, 1]


def test_follower_raises_when_its_controller_dies(ref):
    """rank 0 places an index, then exits without announcing the end: its
    follower raises within the mesh's timeout instead of hanging."""
    d = ref.d / "orphan"
    d.mkdir()
    (d / "inputs.npz").symlink_to(ref.d / "inputs.npz")
    env = dict(os.environ, PYTHONPATH=f"{REPO / 'src'}:{REPO}", OMP_NUM_THREADS="1")
    t0 = time.monotonic()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tests.torch_dist_ranks", "orphan", "--rank", str(r), "--world",
         "2", "--shape", "2", "--axes", "data", "--store", str(d / "store"), "--dir", str(d),
         "--timeout", "10"], cwd=REPO, env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL) for r in range(2)]
    try:
        for p in procs:
            p.wait(timeout=SPAWN_LIMIT_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert not (d / "rank1.err").exists(), (d / "rank1.err").read_text()
    out = dict(np.load(d / "rank1.npz"))
    assert int(out["orphan_raised"]) == 1
    assert float(out["orphan_seconds"]) < 10 + 5
    assert time.monotonic() - t0 < SPAWN_LIMIT_S


def test_chip_smoke_phase13_rehearsal(monkeypatch, capsys):
    """chip_smoke.py's phase 13 on the CPU at a tiny size, under gloo in this
    process (its process group is destroyed at the end of the phase): phase
    5's pools, then (a)-(e), the refusals and the launch counts (0 here)."""
    import collections

    import importlib

    import chip_smoke as cs
    from repro_torch.core import index as tindex
    from repro_torch.data.corpus import CorpusConfig as TCorpusConfig
    from repro_torch.data.corpus import make_corpus as t_make_corpus

    small = ranks.R_BUILD
    monkeypatch.setattr(cs, "N_SEGMENT", 128)
    monkeypatch.setattr(cs, "N_QUERIES", 16)
    monkeypatch.setattr(cs, "MESH_BUILD", small)
    monkeypatch.setattr(cs, "MESH_BUILD_DOCS", 256)
    # both phases' searches at a small breadth (the host round loop is the
    # cost here): SearchParams' defaults, the class itself kept (it travels
    # pickled in the announcements)
    params_cls = importlib.import_module("repro_torch.core.search").SearchParams
    monkeypatch.setattr(params_cls.__init__, "__defaults__", tuple(
        {"iters": 8, "pool_size": 16}.get(f.name, f.default)
        for f in dataclasses.fields(params_cls)))
    c = t_make_corpus(TCorpusConfig(n_docs=512, n_queries=16, n_topics=16, d_dense=32, seed=0),
                      device="cpu")
    results = collections.defaultdict(lambda: {"launches": 0, "max_abs_err": 0.0, "checks": []})
    served: dict = {}
    with monkeypatch.context() as m:  # phase 5 at the small config, its launch gates off
        m.setattr(tindex, "BuildConfig", lambda: small)
        m.setattr(cs, "need", lambda cond, msg: None)
        cs.phase_serving(c, results, device="cpu", keep=served)
    cs.phase_mesh(c, served, results, device="cpu")
    text = capsys.readouterr().out
    for line in ("(a) float32 rrf", "(a) int8 keyword", "(b) int8 three_path", "(c) build",
                 "(d) descent round", "refusals"):
        assert f"phase 13 {line}" in text
    assert "ids differ" in text.split("phase 13 (e)")[1]  # both planted faults read
    assert not torch.distributed.is_initialized()
