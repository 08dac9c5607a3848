"""The port's LM serving side over a device mesh, on CPU ranks under gloo,
against repro:

  (i)   ``ServeConfig`` has repro's fields and defaults;
  (ii)  the cases reach every branch of ``cache_specs``;
  (iii) ``ServingEngine(mesh=)`` gives repro's one-device greedy tokens,
        with the logits of prefill and of every decode step within 1e-4, on
        worlds 8 at (2, 2, 2), 4 at (1, 1, 4) and 2 at (1, 2, 1);
  (iv)  each rank's cache blocks after prefill equal the blocks of repro's
        whole prefill cache that ``NamedSharding(mesh, spec)`` gives its
        device (shapes exactly, values to 1e-5 of the leaf's largest), and
        ``gather_cache`` then ``shard_cache`` gives them back; ``cache_shardings``
        gives their shapes;
  (v)   world 8 against repro's own ``ServingEngine(mesh=)`` on an
        ``AxisType.Auto`` (2, 2, 2) mesh;
  (vi)  the sequence-split decode's combine: ``partial_softmax`` with no
        valid position, and decode at positions inside the first rank's
        block, on block boundaries and with ranks whose blocks lie wholly
        beyond ``pos``, against one-device decode, with no NaN.

Each world is one spawned run of ``tests/torch_dist_ranks.py`` (processes
that import torch and repro_torch only); repro's references run in
subprocesses of their own (``tests/serve_mesh_jax.py``, 8 fake devices),
beside the worlds. Every model is a smoke config at fp32 with random
parameters (the port's draws, carried to repro by ``convert``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.serving.engine import ServeConfig as RServeConfig  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.attention import partial_softmax  # noqa: E402
from repro_torch.serving.engine import ServeConfig  # noqa: E402
from tests import torch_dist_ranks as ranks  # noqa: E402
from tests.test_torch_distributed import REPO, join, start  # noqa: E402

WORLDS = {  # name: (size, shape, cases)
    "8": (8, (2, 2, 2), ("llama", "llama_odd", "dsv3", "dsv3_ep", "rwkv", "zamba", "vlm",
                         "whisper")),
    "4": (4, (1, 1, 4), ("llama", "llama_rep", "edge", "dsv3", "dsv3_lat", "rwkv", "rwkv_hd64",
                         "zamba", "vlm", "whisper_kv2")),
    "2": (2, (1, 2, 1), ("llama", "dsv3", "zamba")),
}
CELLS = [(w, c) for w, (_, _, cs) in WORLDS.items() for c in cs]
AUTO = ("llama", "dsv3", "rwkv", "zamba", "vlm", "whisper")  # world 8's against repro's mesh
JAX_GROUPS = (("llama", "llama_odd", "llama_rep", "edge", "rwkv", "rwkv_hd64"),
              ("dsv3", "dsv3_lat", "dsv3_ep", "whisper", "whisper_kv2"), ("zamba", "vlm"))
JAX_LIMIT_S = 150.0
LOGIT_TOL = 1e-4
BLOCK_TOL = 1e-5


def _shape_name(shape) -> str:
    return "x".join(map(str, shape))


def _params(name: str) -> dict:
    from repro_torch.convert import model_params_to_numpy

    cfg = ranks.serve_config(name)[0]
    return model_params_to_numpy(tfm.init_params(cfg, torch.Generator().manual_seed(5), "cpu"))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The inputs, then the worlds and repro's references started."""
    d = tmp_path_factory.mktemp("lm_serve_mesh")
    rng = np.random.default_rng(0)
    inp = {}
    for name in ranks.SERVE_CASES:
        cfg, b, lp, _, _ = ranks.serve_config(name)
        ranks.flatten_tree(_params(name), f"serve_{name}_params", inp)
        inp[f"serve_{name}_prompts"] = rng.integers(0, cfg.vocab, (b, lp), dtype=np.int32)
        if cfg.family in ("vlm", "audio"):
            inp[f"serve_{name}_frontend"] = rng.standard_normal(
                (b, cfg.n_frontend_tokens, cfg.d_model), dtype=np.float32)
    np.savez(d / "inputs.npz", **inp)
    shapes = {}
    for _, shape, cases in WORLDS.values():
        for c in cases:
            shapes.setdefault(c, []).append(list(shape))
    assert sorted(c for g in JAX_GROUPS for c in g) == sorted(shapes)
    env = dict(os.environ, PYTHONPATH=f"{REPO / 'src'}:{REPO}", OMP_NUM_THREADS="1")
    jax_procs = [subprocess.Popen(
        [sys.executable, "-m", "tests.serve_mesh_jax", str(d), json.dumps(
            {c: [*ranks.SERVE_CASES[c], shapes[c], list(WORLDS["8"][1]) if c in AUTO else None]
             for c in group})], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for group in JAX_GROUPS]
    started = {}
    for name, (size, shape, cases) in WORLDS.items():
        wd = d / f"w{name}"
        wd.mkdir()
        (wd / "inputs.npz").symlink_to(d / "inputs.npz")
        started[name] = start(wd, size, ",".join(map(str, shape)), "pod,data,model",
                              ",".join(f"serve_lm:{c}" for c in cases))
    return types.SimpleNamespace(d=d, jax_procs=jax_procs, started=started)


@pytest.fixture(scope="module")
def worlds(ref):
    """Every world's ranks' outputs, and repro's references under "jax"."""
    outs = {name: join(handle) for name, handle in ref.started.items()}
    for proc in ref.jax_procs:
        try:
            log, _ = proc.communicate(timeout=JAX_LIMIT_S)
        except subprocess.TimeoutExpired:
            for p in ref.jax_procs:
                p.kill()
            pytest.fail(f"tests.serve_mesh_jax did not end within {JAX_LIMIT_S} s")
        assert proc.returncode == 0, log.decode()[-4000:]
    outs["jax"] = {}
    for group in JAX_GROUPS:
        outs["jax"].update(np.load(ref.d / f"jax_serve_{group[0]}.npz"))
    return outs


# ---------------------------------------------------------------------------
# (i), (ii): no ranks
# ---------------------------------------------------------------------------


def test_serve_config_matches_repro():
    """The port's ServeConfig has repro's fields, in order, with its
    defaults (``batch`` and ``eos_token`` among them)."""
    ours = [(f.name, f.default) for f in dataclasses.fields(ServeConfig)]
    theirs = [(f.name, f.default) for f in dataclasses.fields(RServeConfig)]
    assert ours == theirs


def _specs(world: str, case: str) -> dict:
    _, (pod, data, model), _ = WORLDS[world]
    cfg, b, _, _, max_len = ranks.serve_config(case)
    return tfm.cache_specs(cfg, b, max_len, dp_size=pod * data, model_size=model,
                           multi_pod=True)


def test_cases_reach_every_cache_spec_branch():
    """Over the worlds' cases, ``cache_specs`` takes each of its branches:
    KV heads split, the KV sequence split, a KV cache split neither way;
    MLA's latent split over S and over its last dim; rwkv6's and Mamba2's
    states split by heads (and rwkv6's token shifts split where its heads
    are not); the vlm's and audio's cross caches split by heads and by
    frontend tokens; the batch over ("pod", "data") and not."""
    seen = set()
    for world, case in CELLS:
        for group, tree in _specs(world, case).items():
            for leaf, spec in tree.items():
                lead = 2 if (group == "self" and "vlm" in case) else 1
                b_sh, *rest = spec[lead:]
                seen.add(("batch", b_sh))
                kind = {"k": "kv", "v": "kv", "ckv": "ckv", "krope": "krope", "tm_x": "shift",
                        "cm_x": "shift", "wkv": "wkv", "conv": "conv", "ssm": "ssm"}[leaf]
                if group == "cross":
                    kind = "cross_" + ("vlm" if "vlm" in case else "audio")
                seen.add((kind, tuple(i for i, e in enumerate(rest) if e == "model")))
    want = {("batch", ("pod", "data")), ("batch", None), ("kv", (1,)), ("kv", (0,)), ("kv", ()),
            ("ckv", (0,)), ("ckv", (1,)), ("krope", (0,)), ("krope", ()), ("wkv", (0,)),
            ("wkv", ()), ("shift", (0,)), ("conv", (1,)), ("ssm", (0,)),
            ("cross_vlm", (1,)), ("cross_vlm", (0,)), ("cross_audio", (1,)),
            ("cross_audio", (0,))}
    assert want <= seen, sorted(want - seen, key=str)


def test_partial_softmax_with_no_valid_position():
    """A rank whose positions all lie beyond ``pos``: weights 0, LSE -inf,
    no NaN; with valid positions, the weights normalised among them and the
    LSE that of the valid scores."""
    scores = torch.randn(2, 3, 1, 5)
    w, lse = partial_softmax(scores, torch.zeros(5, dtype=torch.bool), torch.float32)
    assert torch.equal(w, torch.zeros_like(w)) and bool(torch.isneginf(lse).all())
    valid = torch.tensor([True, True, False, True, False])
    w, lse = partial_softmax(scores, valid, torch.float32)
    torch.testing.assert_close(lse[..., 0], torch.logsumexp(scores[..., valid], -1))
    torch.testing.assert_close(w[..., valid], torch.softmax(scores[..., valid], -1))
    assert not bool(w[..., ~valid].any())


# ---------------------------------------------------------------------------
# (iii)-(vi): the worlds
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world,case", CELLS)
def test_mesh_serving_matches_one_device_repro(worlds, world, case):
    """Every rank's tokens equal repro's one-device greedy tokens, and the
    whole logits of prefill and of every decode step are within 1e-4 of
    repro's, finite."""
    j = worlds["jax"]
    for out in worlds[world]:
        np.testing.assert_array_equal(out[f"serve_{case}_tokens"], j[f"{case}_tokens"])
        got = out[f"serve_{case}_logits"]
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, j[f"{case}_logits"], rtol=0, atol=LOGIT_TOL)


@pytest.mark.parametrize("world,case", CELLS)
def test_prefill_blocks_match_repro(worlds, world, case):
    """Each rank's block of every cache leaf after prefill: the shape
    ``cache_shardings`` gives it, and the block ``NamedSharding(mesh,
    spec)`` cuts from repro's whole prefill cache for the same device of a
    mesh of the same shape, to 1e-5 of the leaf's largest magnitude, and
    the same blocks again from ``gather_cache`` then ``shard_cache`` (the
    recurrent states sum up to ~20 over the prompt: rwkv6's wkv differs from
    repro's by up to 6.2e-5 where the KV entries differ by under 1e-5)."""
    j = worlds["jax"]
    prefix = f"{case}_{_shape_name(WORLDS[world][1])}"
    for r, out in enumerate(worlds[world]):
        keys = [k for k in out if k.startswith(f"serve_{case}_cache/")]
        assert keys
        for key in keys:
            leaf = key[len(f"serve_{case}_cache/"):]
            want = j[f"{prefix}_block{r}/{leaf}"]
            assert out[key].shape == want.shape, (leaf, r, out[key].shape, want.shape)
            assert tuple(out[f"serve_{case}_shard/{leaf}"]) == want.shape, leaf
            np.testing.assert_allclose(out[key], want, rtol=0, err_msg=f"{leaf} rank {r}",
                                       atol=BLOCK_TOL * max(float(np.abs(want).max()), 1.0))
        assert bool(out[f"serve_{case}_roundtrip"])


@pytest.mark.parametrize("case", AUTO)
def test_mesh_serving_matches_repro_auto_mesh(worlds, case):
    """World 8 against repro's ServingEngine(mesh=) on an AxisType.Auto
    (2, 2, 2) mesh under jax.set_mesh (which itself gives its one-device
    tokens): the same tokens, logits within 1e-4."""
    j = worlds["jax"]
    np.testing.assert_array_equal(j[f"{case}_auto_tokens"], j[f"{case}_tokens"])
    for out in worlds["8"]:
        np.testing.assert_array_equal(out[f"serve_{case}_tokens"], j[f"{case}_auto_tokens"])
        np.testing.assert_allclose(out[f"serve_{case}_logits"], j[f"{case}_auto_logits"],
                                   rtol=0, atol=LOGIT_TOL)


def test_sequence_split_combine_edges(worlds):
    """World 4's "edge" case: llama's two KV heads on a model axis of 4 split
    the 16 positions into blocks of 4; decode runs at positions 2..9, so
    ``pos`` lies inside the first rank's block (2, 3: ranks 1-3 hold no
    valid position), on block boundaries (3 | 4, 7 | 8) and inside later
    blocks. Every step's logits agree with one-device decode, with no NaN
    in the logits or the cache."""
    _, (_, _, model), _ = WORLDS["4"]
    cfg, b, lp, n, max_len = ranks.serve_config("edge")
    assert _specs("4", "edge")["layers"]["k"][2] == "model"
    block = max_len // model
    steps = list(range(lp, lp + n - 1))
    assert min(steps) < block and block in steps and 2 * block in steps
    assert any(p < block for p in steps)  # ranks 1-3 wholly beyond pos
    j = worlds["jax"]
    for out in worlds["4"]:
        got = out["serve_edge_logits"]
        assert got.shape[0] == n and np.isfinite(got).all()
        for i in range(n):
            np.testing.assert_allclose(got[i], j["edge_logits"][i], rtol=0, atol=LOGIT_TOL,
                                       err_msg=f"step {i} (pos {lp + i - 1})")
        assert all(np.isfinite(v).all() for k, v in out.items()
                   if k.startswith("serve_edge_cache/"))


def test_chip_smoke_phase15_rehearsal(monkeypatch, capsys):
    """chip_smoke.py's phase 15 on the CPU, under gloo in this process (its
    process group destroyed at the end of the phase), with the smoke configs
    in place of the full ones: (a)-(d) read, their gates held (the mesh
    engine's tokens equal the local one's, the planted cache block trips
    the gate), flash launches 0 here."""
    import collections

    import chip_smoke as cs
    import repro_torch.configs as configs

    monkeypatch.setattr(configs, "get_config", configs.get_smoke_config)
    for k, v in dict(RAG_REQUESTS=8, RAG_TOP_K=1, RAG_CTX=8, RAG_PROMPT=8, RAG_GEN=4,
                     RAG_MAX_LEN=24, SERVE_MESH_MOE=(4, 8, 5)).items():
        monkeypatch.setattr(cs, k, v)
    results = collections.defaultdict(lambda: {"launches": 0, "max_abs_err": 0.0, "checks": []})
    cs.phase_lm_serve_mesh(results, device="cpu")
    text = capsys.readouterr().out
    for line in ("(a) setup", "(a) llama3.2-1b", "(d) 4 x 16 prompts", "(b) deepseek-v3-671b", "(c) rwkv6-7b smoke",
                 "(c) zamba2-1.2b smoke", "(c) llama-3.2-vision-90b smoke",
                 "(c) whisper-large-v3 smoke"):
        assert f"phase 15 {line}" in text, line
    assert "FAILED" not in text
    assert not torch.distributed.is_initialized()
