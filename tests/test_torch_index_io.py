"""Index persistence (``repro_torch.checkpoint.index_io``) against repro's
``checkpoint/index_io.py``. For the same index the two packages write equal
manifests (as JSON) and byte-equal leaf files, for an fp32 and an int8
index and for a mixed fp32 / int8 pool; each package loads the other's save
with every leaf equal and the same search ids. A legacy pool manifest
without ``pool_groups`` loads, an uncommitted step raises, a non-pool
checkpoint is refused by ``load_pool``. A save paired with a fitted ingest
pipeline (``ingest=``) writes repro's ingest manifest and arrays byte for
byte before the step commits, and ``load_ingest`` of either package reads
the other's, paired with the latest committed step."""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small tensors: threads only contend with the other workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import index_io as rio  # noqa: E402
from repro.core import build_pipeline as rbp  # noqa: E402
from repro.core import segment_pool as rpool  # noqa: E402
from repro.core.fusion import FusionSpec as RFusionSpec  # noqa: E402
from repro.core.search import SearchParams as RSearchParams  # noqa: E402
from repro.core.search import search as r_search  # noqa: E402
from repro.core.usms import quantize_corpus as r_quantize  # noqa: E402
from repro.data.corpus import CorpusConfig, make_corpus  # noqa: E402
from repro.data.textcorpus import load_bundled_corpus  # noqa: E402
from repro.ingest import IngestConfig as RIngestConfig  # noqa: E402
from repro.ingest import IngestPipeline as RIngestPipeline  # noqa: E402
from repro_torch.checkpoint import index_io as tio  # noqa: E402
from repro_torch.convert import index_from_arrays, pool_from_arrays  # noqa: E402
from repro_torch.ingest import IngestConfig, IngestPipeline  # noqa: E402
from repro_torch.core.fusion import FusionSpec  # noqa: E402
from repro_torch.core.search import SearchParams, search  # noqa: E402
from repro_torch.serving.hybrid_service import HybridSearchService  # noqa: E402
from tests.test_torch_build import to_torch  # noqa: E402
from tests.test_torch_insert import R_CFG  # noqa: E402

PARAMS = dict(k=8, iters=16, pool_size=48)
KINDS = ("index_fp32", "index_int8", "pool_mixed")


@pytest.fixture(scope="module")
def saved():
    """repro's trees of each kind, and the corpus."""
    c = make_corpus(CorpusConfig(n_docs=160, n_queries=8, n_topics=8, d_dense=16, nnz_sparse=8,
                                 nnz_lexical=6, seed=5))
    docs = jax.tree.map(jnp.asarray, c.docs)
    index = rbp.build_index(docs[:96], R_CFG, key=jax.random.key(2), kg_triplets=c.kg.triplets,
                            doc_entities=c.doc_entities[:96], n_entities=c.kg.n_entities)
    pool = rpool.SegmentPool(groups=[])
    for lo, hi, cap, dtype in ((0, 56, 64, "float32"), (56, 112, 64, "float32"),
                               (112, 160, 64, "int8")):
        seg = rpool.build_pool_segment(docs[lo:hi], np.arange(lo, hi), R_CFG, capacity=cap,
                                       key=jax.random.key(lo), corpus_dtype=dtype)
        pool, _ = rpool.append_segment(pool, seg)
    assert pool.n_groups == 2  # fp32 (two segments) and int8 (one)
    pool = rpool.mark_deleted_pool(pool, np.array([3, 120]))
    trees = {"index_fp32": index,
             "index_int8": dataclasses.replace(index, corpus=r_quantize(index.corpus)),
             "pool_mixed": pool}
    return c, trees


def r_save(kind, path, tree):
    (rio.save_pool if kind.startswith("pool") else rio.save_index)(path, tree)


def t_save(kind, path, tree):
    (tio.save_pool if kind.startswith("pool") else tio.save_index)(path, tree)


def t_load(kind, path):
    return (tio.load_pool if kind.startswith("pool") else tio.load_index)(path, device="cpu")


def r_load(kind, path):
    return (rio.load_pool if kind.startswith("pool") else rio.load_index)(path)


def to_port(kind, tree):
    return (pool_from_arrays if kind.startswith("pool") else index_from_arrays)(tree, "cpu")


def port_leaves(tree) -> list:
    if hasattr(tree, "groups"):
        return [t for g in tree.groups for t in g.leaves()]
    return tree._leaves()


def search_ids(c, tree, port: bool):
    """Three-path search ids of the first 8 queries."""
    if hasattr(tree, "groups"):
        if port:
            svc = HybridSearchService(tree, SearchParams(corpus_dtype="int8", **PARAMS))
            return svc.search(to_torch(c.queries), FusionSpec.three_path()).ids.numpy()
        from repro.serving.hybrid_service import HybridSearchService as RService

        svc = RService(tree, RSearchParams(use_kernel=False, corpus_dtype="int8", **PARAMS))
        return np.asarray(svc.search(jax.tree.map(jnp.asarray, c.queries),
                                     RFusionSpec.three_path()).ids)
    dtype = "int8" if hasattr(tree.corpus, "dense_q") else "float32"
    if port:
        return search(tree, to_torch(c.queries), FusionSpec.three_path(),
                      SearchParams(corpus_dtype=dtype, **PARAMS), device="cpu").ids.numpy()
    return np.asarray(r_search(tree, jax.tree.map(jnp.asarray, c.queries),
                               RFusionSpec.three_path(),
                               RSearchParams(use_kernel=False, corpus_dtype=dtype,
                                             **PARAMS)).ids)


@pytest.mark.parametrize("kind", KINDS)
def test_manifests_and_leaf_files_equal(saved, kind, tmp_path):
    _, trees = saved
    r_save(kind, tmp_path / "r", trees[kind])
    t_save(kind, tmp_path / "t", to_port(kind, trees[kind]))
    mr = json.loads((tmp_path / "r" / "step_0" / "manifest.json").read_text())
    mt = json.loads((tmp_path / "t" / "step_0" / "manifest.json").read_text())
    assert mt == mr
    assert (tmp_path / "t" / "step_0.done").exists()
    for i in range(len(mr["leaves"])):
        name = f"leaf_{i}.npy"
        assert (tmp_path / "t" / "step_0" / name).read_bytes() == \
            (tmp_path / "r" / "step_0" / name).read_bytes(), mr["paths"][i]
    if kind == "pool_mixed":
        assert mt["pool_groups"] == ["float32", "int8"]
        assert mt["quantization"]["corpus_dtype"] == "int8"
    else:
        q = mt["quantization"]
        assert q["corpus_dtype"] == kind[-4:].replace("fp32", "float32")
        assert (q["compression_ratio"] > 1.0) == (kind == "index_int8")


@pytest.mark.parametrize("kind", KINDS)
def test_each_package_loads_the_others_save(saved, kind, tmp_path):
    c, trees = saved
    want = trees[kind]
    r_save(kind, tmp_path / "r", want)
    got = t_load(kind, tmp_path / "r")
    for a, b in zip(port_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    t_save(kind, tmp_path / "t", got)
    back = r_load(kind, tmp_path / "t")
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype
    ids_t, ids_r = search_ids(c, got, port=True), search_ids(c, back, port=False)
    assert (ids_t == ids_r).mean() >= 0.95, (ids_t, ids_r)
    np.testing.assert_array_equal(ids_t[:, 0], ids_r[:, 0])


def test_legacy_pool_manifest_loads(saved, tmp_path):
    _, trees = saved
    fp32 = rpool.SegmentPool(groups=trees["pool_mixed"].groups[:1])
    tio.save_pool(tmp_path / "p", to_port("pool", fp32))
    mpath = tmp_path / "p" / "step_0" / "manifest.json"
    manifest = json.loads(mpath.read_text())
    del manifest["pool_groups"]
    mpath.write_text(json.dumps(manifest))
    got = tio.load_pool(tmp_path / "p", device="cpu")
    assert got.capacities == (64,) and got.n_segments == 2
    for a, b in zip(port_leaves(got), jax.tree.leaves(fp32)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert rio.load_pool(tmp_path / "p").capacities == (64,)  # repro reads it the same way


def test_fresh_step_per_save_and_retention(saved, tmp_path):
    _, trees = saved
    idx = to_port("index", trees["index_fp32"])
    tio.save_index(tmp_path / "i", idx)
    tio.save_index(tmp_path / "i", dataclasses.replace(idx, alive=idx.alive.clone()))
    assert (tmp_path / "i" / "step_1.done").exists()
    assert not (tmp_path / "i" / "step_0").exists()  # keep=1
    assert tio.load_index(tmp_path / "i", device="cpu").n == 96
    with pytest.raises(FileNotFoundError):
        tio.load_index(tmp_path / "i", step=0, device="cpu")


def test_missing_uncommitted_and_foreign_checkpoints_raise(saved, tmp_path):
    _, trees = saved
    with pytest.raises(FileNotFoundError):
        tio.load_index(tmp_path / "nope", device="cpu")
    torn = tmp_path / "torn"
    (torn / "step_0").mkdir(parents=True)
    (torn / "step_0" / "manifest.json").write_text("{}")
    with pytest.raises(FileNotFoundError):
        tio.load_pool(torn, device="cpu")  # no .done marker: invisible
    for kind in ("index_fp32", "index_int8"):  # an index is not a pool
        tio.save_index(tmp_path / kind, to_port(kind, trees[kind]))
        with pytest.raises(ValueError):
            tio.load_pool(tmp_path / kind, device="cpu")
    tio.save_pool(tmp_path / "pool", to_port("pool", trees["pool_mixed"]))
    with pytest.raises(ValueError):
        tio.load_index(tmp_path / "pool", device="cpu")


@pytest.fixture(scope="module")
def fitted():
    """The bundled corpus fitted by each package (equal state)."""
    texts = load_bundled_corpus().texts
    r = RIngestPipeline(RIngestConfig(d_dense=16))
    r.fit(texts)
    t = IngestPipeline(IngestConfig(d_dense=16), device="cpu")
    t.fit(texts)
    return texts, r, t


def ingest_files(d) -> dict:
    """The ingest step's manifest bytes and the npz members' bytes (the
    zip's own timestamps aside)."""
    import zipfile

    with zipfile.ZipFile(d / RIngestPipeline.ARRAYS) as z:
        members = {n: z.read(n) for n in sorted(z.namelist())}
    return {"manifest": (d / RIngestPipeline.MANIFEST).read_bytes(), **members}


@pytest.mark.parametrize("kind", ["index_fp32", "pool_mixed"])
def test_ingest_pairing_matches_repro(saved, fitted, tmp_path, kind):
    _, trees = saved
    texts, r, t = fitted
    (rio.save_pool if kind.startswith("pool") else rio.save_index)(
        tmp_path / "r", trees[kind], ingest=r)
    (tio.save_pool if kind.startswith("pool") else tio.save_index)(
        tmp_path / "t", to_port(kind, trees[kind]), ingest=t)
    assert ingest_files(tmp_path / "t" / "ingest_step_0") == \
        ingest_files(tmp_path / "r" / "ingest_step_0")
    want = r.encode_queries(texts[:4])
    for got in (tio.load_ingest(tmp_path / "r", device="cpu").encode_queries(texts[:4]),
                rio.load_ingest(tmp_path / "t").encode_queries(texts[:4])):
        for g, w in zip((got.vectors.dense, got.vectors.lexical.val, got.keywords),
                        (want.vectors.dense, want.vectors.lexical.val, want.keywords)):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    # a second save: the ingest step pairs with the new commit, the old goes
    tio.save_index(tmp_path / "t", to_port("index", trees["index_fp32"]), ingest=t)
    assert sorted(d.name for d in (tmp_path / "t").glob("ingest_step_*")) == ["ingest_step_1"]
    assert tio.load_ingest(tmp_path / "t", device="cpu").entity_vocab.names == \
        t.entity_vocab.names


def test_ingest_and_default_device(saved, fitted, tmp_path):
    _, trees = saved
    texts, _, t = fitted
    idx = to_port("index", trees["index_fp32"])
    with pytest.raises(FileNotFoundError, match="ingest manifest"):
        tio.load_ingest(tmp_path / "i", device="cpu")  # nothing paired yet
    t.save(tmp_path / "legacy" / "ingest")  # the legacy flat layout still loads
    assert tio.load_ingest(tmp_path / "legacy", device="cpu").stats.n_docs == len(texts)
    tio.save_index(tmp_path / "i", idx)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tio.load_index(tmp_path / "i")  # device=None means the card
