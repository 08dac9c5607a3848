"""The port's kernel ops (repro_torch.kernels) against repro's on the same
inputs. repro runs its Pallas kernels in interpret mode (use_kernel=True)
and its jnp oracles (use_kernel=False); the port, on CPU tensors, runs the
plain versions its CUDA kernels are held against. Scores agree to 1e-5 (fp32
sums in another order), positions exactly except across score ties."""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small tensors: threads only contend with the other workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.usms import PAD_IDX  # noqa: E402
from repro.kernels import ops as rops  # noqa: E402
from repro.kernels import ref as rref  # noqa: E402
from repro_torch.convert import fused_from_numpy  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.fused_topk import fused_topk  # noqa: E402
from repro_torch.kernels.hybrid_distance import hybrid_distance  # noqa: E402
from repro_torch.kernels.pairwise_tile import pairwise_tile  # noqa: E402
from tests.helpers import random_fused  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5


def to_torch(f):
    """repro FusedVectors (numpy or jax leaves) -> port FusedVectors on CPU."""
    a = lambda x: np.asarray(x)
    return fused_from_numpy(a(f.dense), a(f.learned.idx), a(f.learned.val),
                            a(f.lexical.idx), a(f.lexical.val), "cpu")


def to_jax(f):
    return jax.tree.map(jnp.asarray, f)


def assert_topk_match(got, want, tol=TOL):
    """Scores to tol; positions exact except where the scores are tied."""
    gs, gi = (np.asarray(x) for x in got)
    ws, wi = (np.asarray(x) for x in want)
    np.testing.assert_allclose(gs, ws, rtol=TOL, atol=tol)
    flip = gi != wi
    assert np.all(np.abs(gs - ws)[flip] <= tol), f"positions diverged:\n{gi}\nvs\n{wi}"
    np.testing.assert_array_equal(gi < 0, wi < 0)


def _case(seed, b, c, *, n=None, dd=16, ps=4, pf=3, pad_frac=0.0, with_bias=False):
    rng = np.random.default_rng(seed)
    q = random_fused(rng, (b,), d_dense=dd, ps=ps, pf=pf, vs=97, vf=31)
    rows = (b, c) if n is None else (n,)
    cands = random_fused(rng, rows, d_dense=dd, ps=ps, pf=pf, vs=97, vf=31)
    hi = 10_000 if n is None else n
    cid = rng.integers(0, hi, size=(b, c)).astype(np.int32)
    cid[rng.random((b, c)) < pad_frac] = PAD_IDX
    bias = rng.normal(size=(b, c)).astype(np.float32) if with_bias else None
    return q, cands, cid, bias


@pytest.mark.parametrize("repro_kernel", [False, True])
@pytest.mark.parametrize("b,c", [(2, 9), (3, 40)])
def test_hybrid_scores_matches_repro(b, c, repro_kernel):
    q, cands, _, _ = _case(b * 100 + c, b, c)
    want = rops.hybrid_scores(to_jax(q), to_jax(cands), c_tile=8,
                              use_kernel=repro_kernel, interpret=repro_kernel)
    got = tops.hybrid_scores(to_torch(q), to_torch(cands))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_hybrid_scores_vs_ids_masks_pad_to_minus_inf():
    q, corpus, ids, _ = _case(4, 3, 17, n=50, pad_frac=0.3)
    ids[0] = PAD_IDX  # an all-PAD row
    want = np.asarray(rops.hybrid_scores_vs_ids(
        to_jax(q), to_jax(corpus), jnp.asarray(ids), use_kernel=False))
    got = tops.hybrid_scores_vs_ids(to_torch(q), to_torch(corpus), torch.as_tensor(ids)).numpy()
    np.testing.assert_array_equal(np.isneginf(got), ids < 0)
    np.testing.assert_array_equal(np.isneginf(want), np.isneginf(got))
    live = ids >= 0
    np.testing.assert_allclose(got[live], want[live], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("repro_kernel", [False, True])
@pytest.mark.parametrize(
    "b,c,k,pad_frac,with_bias",
    [(2, 40, 10, 0.0, False), (3, 33, 5, 0.3, True), (1, 7, 7, 0.5, False), (2, 20, 32, 0.1, True)],
)
def test_fused_topk_matches_repro(b, c, k, pad_frac, with_bias, repro_kernel):
    q, cands, cid, bias = _case(b * 7 + c + k, b, c, pad_frac=pad_frac, with_bias=with_bias)
    want = rops.fused_topk(
        to_jax(q), to_jax(cands), jnp.asarray(cid), k,
        bias=None if bias is None else jnp.asarray(bias), c_tile=8,
        use_kernel=repro_kernel, interpret=repro_kernel)
    got = tops.fused_topk(to_torch(q), to_torch(cands), torch.as_tensor(cid), k,
                          bias=None if bias is None else torch.as_tensor(bias))
    assert got[0].shape == (b, k) and got[1].dtype == torch.int32
    assert_topk_match(got, want)


@pytest.mark.parametrize("with_bias", [False, True])
def test_fused_topk_vs_ids_edge_rows(with_bias):
    """All-PAD rows, k above the live count, and planted ties (one row id
    repeated: exactly equal scores, lowest position first)."""
    q, corpus, ids, bias = _case(21, 4, 12, n=60, with_bias=with_bias)
    ids[0] = PAD_IDX
    ids[1, 3:] = PAD_IDX
    ids[2] = 17
    ids[3, ::2] = 5
    if bias is not None:
        bias[2:4] = 0.0
    k = 9
    want = rops.fused_topk_vs_ids(
        to_jax(q), to_jax(corpus), jnp.asarray(ids), k,
        bias=None if bias is None else jnp.asarray(bias), use_kernel=False)
    got = tops.fused_topk_vs_ids(to_torch(q), to_torch(corpus), torch.as_tensor(ids), k,
                                 bias=None if bias is None else torch.as_tensor(bias))
    assert_topk_match(got, want)
    s, p = got[0].numpy(), got[1].numpy()
    assert np.all(s[0] == tref.NEG) and np.all(p[0] == PAD_IDX)
    assert np.all(p[1, 3:] == PAD_IDX) and np.all(p[1, :3] >= 0)
    np.testing.assert_array_equal(p[2], np.arange(k))  # exact ties: lowest position first
    tied = p[3][p[3] % 2 == 0]  # the repeated id sits at the even positions
    np.testing.assert_array_equal(tied, np.sort(tied))


def test_pairwise_tile_matches_repro():
    rng = np.random.default_rng(3)
    tile = random_fused(rng, (6, 8), d_dense=24, ps=7, pf=5)
    for repro_kernel in (False, True):
        want = rops.pairwise_tile_scores(to_jax(tile), use_kernel=repro_kernel,
                                         interpret=repro_kernel)
        got = tops.pairwise_tile_scores(to_torch(tile))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_pairwise_tile_vs_ids_gathers_pad_as_row_zero():
    """The prune path's id form: PAD ids gather row 0, as repro's take."""
    rng = np.random.default_rng(7)
    corpus = random_fused(rng, (40,), d_dense=24, ps=7, pf=5)
    ids = rng.integers(0, 40, size=(5, 6)).astype(np.int32)
    ids[0, -2:] = PAD_IDX
    rows = to_jax(corpus).take(jnp.asarray(ids.reshape(-1)))
    tile = jax.tree.map(lambda a: a.reshape((5, 6) + a.shape[1:]), rows)
    want = np.asarray(rref.pairwise_tile_ref(tile))
    got = tops.pairwise_tile_scores_vs_ids(to_torch(corpus), torch.as_tensor(ids)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_brute_force_ground_truth_matches_repro():
    rng = np.random.default_rng(5)
    queries = random_fused(rng, (6,), d_dense=16, ps=5, pf=4)
    corpus = random_fused(rng, (70,), d_dense=16, ps=5, pf=4)
    want = np.asarray(rops.pairwise_scores_chunked(to_jax(queries), to_jax(corpus), chunk=32))
    got = tops.pairwise_scores_chunked(to_torch(queries), to_torch(corpus), chunk=32).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    ws, wi = rops.topk_hybrid(to_jax(queries), to_jax(corpus), 7, chunk=32)
    gs, gi = tops.topk_hybrid(to_torch(queries), to_torch(corpus), 7, chunk=32)
    assert_topk_match((gs, gi), (ws, wi))
    # the all-pairs oracle equals the chunked ground truth
    np.testing.assert_allclose(
        tref.pairwise_hybrid_scores_ref(to_torch(queries), to_torch(corpus)).numpy(), want,
        rtol=TOL, atol=TOL)


def test_usms_matches_repro():
    """Theorem-1 query weighting (scalar and per-query weights), keyword
    overlap and the byte accounting against repro.core.usms."""
    from repro.core import usms as rusms
    from repro_torch.core import usms as tusms

    q, cands, _, _ = _case(12, 4, 3)
    for rw, tw in (
        (rusms.PathWeights.make(0.7, 0.3, 0.1), tusms.PathWeights.make(0.7, 0.3, 0.1)),
        (rusms.stack_weights([rusms.PathWeights.make(i, 1.0 - i / 4, 2.0) for i in range(4)]),
         tusms.stack_weights([tusms.PathWeights.make(i, 1.0 - i / 4, 2.0) for i in range(4)])),
    ):
        want = rusms.weighted_query(to_jax(q), rw)
        got = tusms.weighted_query(to_torch(q), tw)
        for g, w in zip(got.tensors(), (want.dense, want.learned.idx, want.learned.val,
                                        want.lexical.idx, want.lexical.val)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)
    a, b = q.lexical.idx, cands.lexical.idx[:, 0]
    np.testing.assert_array_equal(
        tusms.keyword_overlap(torch.as_tensor(a), torch.as_tensor(b)).numpy(),
        np.asarray(rusms.keyword_overlap(jnp.asarray(a), jnp.asarray(b))))
    assert tusms.corpus_nbytes_by_leaf(to_torch(cands)) == rusms.corpus_nbytes_by_leaf(
        to_jax(cands))


def test_take_topk_resolves_positions():
    ids = torch.tensor([[4, 8, 15, 16]], dtype=torch.int32)
    pos = torch.tensor([[2, -1, 0]], dtype=torch.int32)
    np.testing.assert_array_equal(tops.take_topk_ids(ids, pos).numpy(), [[15, PAD_IDX, 4]])
    np.testing.assert_array_equal(
        np.asarray(rops.take_topk_ids(jnp.asarray(ids.numpy()), jnp.asarray(pos.numpy()))),
        [[15, PAD_IDX, 4]])


def test_topk_desc_breaks_ties_like_lax_top_k():
    x = np.array([[1, 3, 3, 2, 3]], np.float32)
    _, want = jax.lax.top_k(jnp.asarray(x), 3)
    _, got = tref.topk_desc(torch.as_tensor(x), 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_wrappers_reject_mixed_devices_and_bad_operands():
    q, corpus, ids, _ = _case(2, 2, 5, n=20)
    tq, tc = to_torch(q), to_torch(corpus)
    with pytest.raises(ValueError):
        hybrid_distance(tq, tc, torch.as_tensor(ids).to("meta"))
    with pytest.raises(ValueError):
        fused_topk(tq, tc, torch.as_tensor(ids), 0)


def test_port_imports_no_jax():
    """Import every repro_torch module in a fresh interpreter: neither jax
    nor repro may load."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print(' '.join(m for m in sys.modules if m.startswith('repro_torch')))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = set(out.stdout.split())
    assert len(loaded) >= 30
    # the training slice's modules are among those imported
    assert {f"repro_torch.{m}" for m in (
        "training.optimizer", "training.train_loop", "training.grad_compression",
        "data.pipeline", "runtime.fault_tolerance", "checkpoint.checkpoint", "launch.train",
    )} <= loaded


def test_chip_smoke_fails_without_cuda_or_repo(tmp_path):
    """chip_smoke.py exits nonzero and prints no result without a card, and
    alone in a directory without the repo."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    for script in (ROOT / "chip_smoke.py", alone):
        out = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                             cwd=script.parent, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


def test_entry_points_need_cuda_by_default():
    from repro_torch.core.build_pipeline import build_index
    from repro_torch.data.corpus import CorpusConfig, make_corpus
    from repro_torch.device import resolve_device

    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    with pytest.raises(RuntimeError):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        make_corpus(CorpusConfig(n_docs=64, n_queries=4, n_topics=4, d_dense=8))
    rng = np.random.default_rng(0)
    with pytest.raises(RuntimeError):
        build_index(to_torch(random_fused(rng, (16,), d_dense=8)))
