"""The port's vlm and audio families (cross-attention and whisper's
non-causal encoder in ``repro_torch.models.attention``, the vlm and audio
branches of ``repro_torch.models.transformer``, ``convert``, the token
pipeline's frontend, the engine and the launchers) against repro's, on
numpy inputs from a seed and on the llama-3.2-vision-90b and
whisper-large-v3 smoke configs with parameters carried across by
``convert.py``.

Tolerances are tests/test_torch_models.py's and tests/test_torch_ssm.py's:
modules at fp32 1e-4 and at bf16 2e-2 of each tensor's largest |value|
(the two frameworks round bf16 at other places); whole models at fp32 only,
1e-4, their gradients 1e-4 of each leaf's largest |value|. repro's flash
runs its Pallas kernels in interpret mode with ``flash_block_q`` and
``flash_block_k`` dividing L and S: they give NaN where a length exceeds
the block and is not a multiple of it (ROADMAP Queue 3). The model tests
draw the frontend at unit scale, where the served stub draws 0.02: the
vlm's frontend enters its cross-attention unnormalised, and at 0.02 its
share of the logits sits under the fp32 tolerance.
"""

from __future__ import annotations

import dataclasses
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

from repro.configs import get_smoke_config as r_smoke_config  # noqa: E402
from repro.data.pipeline import DataConfig as RDataConfig  # noqa: E402
from repro.data.pipeline import TokenPipeline as RTokenPipeline  # noqa: E402
from repro.models import attention as rattn  # noqa: E402
from repro.models import transformer as rtfm  # noqa: E402
from repro.serving.engine import ServeConfig as RServeConfig  # noqa: E402
from repro.serving.engine import ServingEngine as RServingEngine  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    _stacked_tree,
    model_params_from_numpy,
    model_params_to_numpy,
    train_state_from_numpy,
    train_state_to_numpy,
)
from repro_torch.data.pipeline import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.serving.engine import ServeConfig, ServingEngine  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
VLM, AUDIO = "llama-3.2-vision-90b", "whisper-large-v3"
ARCHS = [VLM, AUDIO]
TOL = {"float32": 1e-4, "bfloat16": 2e-2}  # tests/test_torch_models.py:35
L = 16  # decoder tokens of the model tests


def _carried(arch, dtype="float32", seed=0, **kw):
    """repro's random parameters and the port's copy of them."""
    rcfg = dataclasses.replace(r_smoke_config(arch), dtype=dtype, **kw)
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype, **kw)
    params = rtfm.init_params(jax.random.key(seed), rcfg)
    model = model_params_from_numpy(tcfg, jax.tree.map(np.asarray, params), "cpu")
    return rcfg, tcfg, params, model


def _tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape).astype(np.int32)


def _frontend(cfg, b, seed=2, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(
        size=(b, cfg.n_frontend_tokens, cfg.d_model))).astype(np.float32)


def _jt(a, dtype):
    """numpy -> (jax array, torch tensor) of ``dtype``, the same values."""
    j = jnp.asarray(a, getattr(jnp, dtype))
    return j, torch.tensor(np.asarray(j, np.float32)).to(getattr(torch, dtype))


def _close(got, want, tol, scaled: bool = False):
    """|got - want| <= tol + tol |want|; ``scaled``: tol max |want| + tol |want|."""
    want = np.asarray(want, np.float32)
    atol = tol * max(1.0, float(np.abs(want).max())) if scaled else tol
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=tol, atol=atol)


def _same_tree(got_tree, want_tree, tol):
    got = dict(jax.tree_util.tree_leaves_with_path(got_tree))
    flat = jax.tree_util.tree_leaves_with_path(want_tree)
    assert len(flat) == len(got)
    for path, leaf in flat:
        assert tuple(got[path].shape) == leaf.shape, path
        _close(got[path], leaf, tol, scaled=True)


# ---------------------------------------------------------------------------
# attention modules
# ---------------------------------------------------------------------------


def _module_cfgs(arch, dtype, impl):
    """Blocks of 8 divide every length below (16, 24, 40)."""
    return _carried(arch, dtype, attn_impl=impl, flash_block_q=8, flash_block_k=8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["naive", "flash"])
def test_cross_attention_matches_repro(dtype, impl):
    """The vlm's cross-attention (GQA 4 / 2, L 16 queries over S 40
    frontend keys: non-causal, L != S, no RoPE) full-sequence, with the
    cache it returns, and its decode over that cache."""
    rcfg, tcfg, params, model = _module_cfgs(VLM, dtype, impl)
    rp = jax.tree.map(lambda a: a[1], params["groups"]["cross"]["attn"])
    tp = model.groups[1].cross.attn
    rng = np.random.default_rng(3)
    x, tx = _jt(rng.normal(size=(2, 16, tcfg.d_model)), dtype)
    src, tsrc = _jt(rng.normal(size=(2, 40, tcfg.d_model)), dtype)
    pos = np.arange(16, dtype=np.int32)[None]
    want, wc = rattn.apply_attention(rp, rcfg, x, jnp.asarray(pos), causal=False, kv_src=src)
    with torch.no_grad():
        got, gc = tattn.apply_attention(tp, tcfg, tx, torch.as_tensor(pos), causal=False,
                                        kv_src=tsrc)
    assert got.dtype == tx.dtype and tuple(gc["k"].shape) == (2, 40, 2, 32)
    _close(got, want, TOL[dtype], scaled=True)
    for key in ("k", "v"):
        _close(gc[key], wc[key], TOL[dtype], scaled=True)

    x1, tx1 = _jt(rng.normal(size=(2, 1, tcfg.d_model)), dtype)
    want = rattn.apply_cross_attention_decode(rp, rcfg, x1, wc)
    k_before = gc["k"].clone()
    with torch.no_grad():
        got = tattn.apply_cross_attention_decode(tp, tcfg, tx1, gc)
    _close(got, want, TOL[dtype], scaled=True)
    assert torch.equal(gc["k"], k_before)  # read, never written


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["naive", "flash"])
def test_whisper_encoder_block_matches_repro(dtype, impl):
    """One of whisper's encoder blocks: causal=False with RoPE over L = S =
    24 frames, MHA 4 / 4; and a decoder layer's cross-attention over them."""
    rcfg, tcfg, params, model = _module_cfgs(AUDIO, dtype, impl)
    rp = jax.tree.map(lambda a: a[0], params["encoder"])
    x, tx = _jt(np.random.default_rng(4).normal(size=(2, 24, tcfg.d_model)), dtype)
    pos = np.arange(24, dtype=np.int32)[None]
    want, _, wc = rtfm._block_seq(rp, rcfg, x, jnp.asarray(pos), causal=False,
                                  collect_cache=True)
    with torch.no_grad():
        got, aux, gc = tfm._block_seq(model.encoder[0], tcfg, tx, torch.as_tensor(pos),
                                      causal=False)
    assert aux is None
    _close(got, want, TOL[dtype], scaled=True)
    for key in ("k", "v"):
        _close(gc[key], wc[key], TOL[dtype], scaled=True)
    # the mask is off: the first frame's output moves when the last frame does
    x2 = tx.clone()
    x2[:, -1] += 1.0
    with torch.no_grad():
        moved = tfm._block_seq(model.encoder[0], tcfg, x2, torch.as_tensor(pos), causal=False)[0]
    assert float((moved[:, 0] - got[:, 0]).abs().max()) > 0

    h, th = _jt(np.random.default_rng(5).normal(size=(2, 16, tcfg.d_model)), dtype)
    lp = jax.tree.map(lambda a: a[1], params["layers"])
    want, _ = rattn.apply_attention(lp["cross"], rcfg, h, jnp.asarray(pos[:, :16]),
                                    causal=False, kv_src=x)
    with torch.no_grad():
        got, _ = tattn.apply_attention(model.layers[1].cross, tcfg, th,
                                       torch.as_tensor(pos[:, :16]), causal=False, kv_src=tx)
    _close(got, want, TOL[dtype], scaled=True)


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["naive", "flash"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_decode_match_repro(arch, impl):
    """At fp32: the forward's logits, prefill of 12 tokens (its logits and
    the cache tree leaf by leaf: self and cross) and 4 decode steps, each
    step's logits and the cache after the last."""
    rcfg, tcfg, params, model = _carried(arch, attn_impl=impl)
    tokens = _tokens(tcfg, (2, L))
    fe, tfe = _jt(_frontend(tcfg, 2), "float32")
    want, _, _ = jax.jit(rtfm.make_forward(rcfg))(params, jnp.asarray(tokens), fe)
    with torch.no_grad():
        got, aux, mtp = tfm.make_forward(tcfg)(model, torch.as_tensor(tokens), tfe)
    assert got.shape == (2, L, tcfg.vocab) and mtp is None and float(aux) == 0.0
    _close(got, want, TOL["float32"])

    lp, cache = jax.jit(rtfm.make_prefill(rcfg, L))(params, jnp.asarray(tokens[:, :12]), fe)
    gp, tcache = tfm.make_prefill(tcfg, L)(model, torch.as_tensor(tokens[:, :12]), tfe)
    _close(gp, lp, TOL["float32"])
    _same_tree(tcache, cache, TOL["float32"])
    decode = jax.jit(rtfm.make_decode_step(rcfg))
    tdecode = tfm.make_decode_step(tcfg)
    for pos in range(12, L):
        lp, cache = decode(params, jnp.asarray(tokens[:, pos]), cache, jnp.int32(pos))
        gp, tcache = tdecode(model, torch.as_tensor(tokens[:, pos]), tcache, pos)
        _close(gp, lp, TOL["float32"])
    _same_tree(tcache, cache, TOL["float32"])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_forward(arch):
    """Teacher-forced decode after prefill reproduces the forward logits on
    the port alone (tests/test_models_smoke.py:62's check, fp32); decode
    writes the self cache in place and leaves the cross cache as prefill
    wrote it, bit for bit."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    model = tfm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.as_tensor(_tokens(cfg, (2, L)))
    fe = torch.as_tensor(_frontend(cfg, 2))
    with torch.no_grad():
        full, _, _ = tfm.make_forward(cfg)(model, tokens, fe)
    logits, cache = tfm.make_prefill(cfg, L)(model, tokens[:, :8], fe)
    np.testing.assert_allclose(logits.numpy(), full[:, 7].numpy(), rtol=2e-3, atol=2e-3)
    ptrs = {(g, k): t.data_ptr() for g, tree in cache.items() for k, t in tree.items()}
    cross = {k: t.clone() for k, t in cache["cross"].items()}
    decode = tfm.make_decode_step(cfg)
    for pos in range(8, L):
        logits, cache = decode(model, tokens[:, pos], cache, pos)
        np.testing.assert_allclose(logits.numpy(), full[:, pos].numpy(), rtol=5e-3, atol=5e-3)
    assert ptrs == {(g, k): t.data_ptr() for g, tree in cache.items() for k, t in tree.items()}
    assert all(torch.equal(cache["cross"][k], t) for k, t in cross.items())
    with pytest.raises(ValueError, match="frontend"):
        tfm.make_prefill(cfg, L)(model, tokens[:, :8])
    with pytest.raises(ValueError, match="frontend shape"):
        tfm.make_prefill(cfg, L)(model, tokens[:, :8], fe[:, :-1])


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_greedy_tokens_match_repro(arch):
    """``ServingEngine.generate(..., frontend=)`` at fp32 gives repro's
    greedy tokens exactly, from the stub frontend at its served scale."""
    rcfg, tcfg, params, model = _carried(arch)
    prompts = _tokens(tcfg, (2, 6), seed=6)
    fe, tfe = _jt(_frontend(tcfg, 2, seed=7, scale=0.02), "float32")
    want = RServingEngine(rcfg, params, RServeConfig(max_len=16)).generate(
        jnp.asarray(prompts), 8, frontend=fe)
    got = ServingEngine(tcfg, model, ServeConfig(max_len=16)).generate(
        torch.as_tensor(prompts), 8, frontend=tfe)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_repro(arch, remat):
    """The loss (the port's with ``batch["frontend"]`` in bf16, as the
    pipeline gives it; repro's with the same values in fp32: its audio
    encoder's scan refuses a bf16 frontend under an fp32 model, ROADMAP
    Queue 3) and the gradient of every parameter at fp32 (1e-4 of the leaf's
    largest |value|), under each remat policy: the cross-attention's
    projections, the encoder and enc_norm among them."""
    rcfg, tcfg, params, model = _carried(arch, remat=remat)
    tokens = _tokens(tcfg, (2, L))
    fe, tfe = _jt(_frontend(tcfg, 2), "bfloat16")
    want, want_grads = jax.jit(jax.value_and_grad(rtfm.make_loss_fn(rcfg)))(
        params, {"tokens": jnp.asarray(tokens), "frontend": fe.astype(jnp.float32)})
    loss = tfm.make_loss_fn(tcfg)(model, {"tokens": torch.as_tensor(tokens), "frontend": tfe})
    names, leaves = zip(*model.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    got = jax.tree.map(lambda t: t.float().numpy(), _stacked_tree(model, grads))
    got = dict(jax.tree_util.tree_leaves_with_path(got))
    flat = jax.tree_util.tree_leaves_with_path(want_grads)
    assert len(flat) == len(got)
    for path, g in flat:
        _close(torch.tensor(got[path]), g, 1e-4, scaled=True)


@pytest.mark.parametrize("arch", ARCHS)
def test_grads_equal_across_remat(arch):
    """The port's loss gradients are the same bits under remat none, full
    and dots (an audio decoder layer recomputes with its cross-attention)."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    model = tfm.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    batch = {"tokens": torch.as_tensor(_tokens(cfg, (2, L))),
             "frontend": torch.as_tensor(_frontend(cfg, 2)).to(torch.bfloat16)}
    out = {}
    for remat in ("none", "full", "dots"):
        loss = tfm.make_loss_fn(dataclasses.replace(cfg, remat=remat))(model, batch)
        out[remat] = torch.autograd.grad(loss, list(model.parameters()))
    for remat in ("full", "dots"):
        assert all(torch.equal(a, b) for a, b in zip(out["none"], out[remat])), remat


@pytest.mark.parametrize("arch", ARCHS)
def test_params_train_state_and_cache_shape(arch):
    """Parameters repro -> port -> numpy bit for bit at fp32 and bf16 (the
    vlm's groups stacked twice, whisper's encoder and cross leaves); a
    train state the same; the cache tree matches repro's by keys, shapes
    and dtypes, its cross leaves fixed by n_frontend_tokens."""
    from repro.training import optimizer as ropt

    for dtype in ("float32", "bfloat16"):
        rcfg, tcfg, params, model = _carried(arch, dtype)
        back = dict(jax.tree_util.tree_leaves_with_path(model_params_to_numpy(model)))
        flat = jax.tree_util.tree_leaves_with_path(params)
        assert len(flat) == len(back)
        for path, leaf in flat:
            np.testing.assert_array_equal(back[path], np.asarray(leaf, np.float32))
        for max_len in (40, 80):
            got = dict(jax.tree_util.tree_leaves_with_path(
                tfm.cache_shape(tcfg, 3, max_len),
                is_leaf=lambda s: isinstance(s, tattn.TensorSpec)))
            want = jax.tree_util.tree_leaves_with_path(rtfm.cache_shape(rcfg, 3, max_len))
            assert len(got) == len(want)
            for path, s in want:
                assert tuple(got[path].shape) == tuple(s.shape), path
                assert str(got[path].dtype).removeprefix("torch.") == str(s.dtype)

    rcfg = r_smoke_config(arch)
    rparams = rtfm.init_params(jax.random.key(1), rcfg)
    rstate = {"params": rparams, "opt": ropt.init_opt_state(rparams, ropt.OptConfig())}
    rstate["opt"]["m"] = jax.tree.map(lambda a: a + 0.5, rstate["opt"]["m"])
    state = train_state_from_numpy(get_smoke_config(arch), jax.tree.map(np.asarray, rstate),
                                   "cpu")
    back = dict(jax.tree_util.tree_leaves_with_path(train_state_to_numpy(state)))
    for path, leaf in jax.tree_util.tree_leaves_with_path(rstate):
        np.testing.assert_array_equal(back[path], np.asarray(leaf, np.float32), err_msg=str(path))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_uses_repros_scales(arch):
    """The port's draws differ from jax.random's, their scales and shapes do
    not: each leaf's std and mean within 4 sampling errors and 2% of
    repro's (tests/test_torch_ssm.py's check)."""
    rcfg = dataclasses.replace(r_smoke_config(arch), dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    want = jax.tree_util.tree_leaves_with_path(rtfm.init_params(jax.random.key(0), rcfg))
    got = dict(jax.tree_util.tree_leaves_with_path(model_params_to_numpy(
        tfm.init_params(tcfg, torch.Generator().manual_seed(0), "cpu"))))
    assert len(want) == len(got)
    for path, leaf in want:
        r, t = np.asarray(leaf), got[path]
        assert r.shape == t.shape, path
        np.testing.assert_allclose(t.std(), r.std(), rtol=0.02 + 4.0 / np.sqrt(r.size),
                                   atol=1e-6, err_msg=str(path))
        np.testing.assert_allclose(t.mean(), r.mean(),
                                   atol=(0.02 + 4.0 * np.sqrt(2.0 / r.size)) * r.std() + 1e-6,
                                   err_msg=str(path))


# ---------------------------------------------------------------------------
# data, launchers, the chip phase
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,n_hosts", [(0, 1), (5, 2)])
def test_token_pipeline_frontend_bit_for_bit(seed, n_hosts):
    """The stub frontend (normal(0, 0.02) after the tokens' draws, cast to
    bf16) equals repro's bit for bit, the tokens too."""
    kw = dict(vocab=600, seq_len=12, global_batch=4, seed=seed, frontend_tokens=24, d_model=48)
    for host in range(n_hosts):
        rp = RTokenPipeline(RDataConfig(**kw), host_id=host, n_hosts=n_hosts)
        tp = TokenPipeline(DataConfig(**kw), host_id=host, n_hosts=n_hosts, device="cpu")
        for step in (0, 3):
            got, want = tp.batch(step), rp.batch(step)
            assert got["frontend"].dtype == torch.bfloat16
            assert tuple(got["frontend"].shape) == (4 // n_hosts, 24, 48)
            np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(want["tokens"]))
            np.testing.assert_array_equal(got["frontend"].view(torch.int16).numpy(),
                                          np.asarray(want["frontend"]).view(np.int16))


@pytest.mark.parametrize("mod,arch", [("serve", VLM), ("serve", AUDIO), ("train", AUDIO),
                                      ("train", VLM)])
def test_launchers_run_on_cpu(mod, arch):
    """``launch.serve`` and ``launch.train`` run the smoke configs on the CPU
    with the stub frontend."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    extra = (["--requests", "2", "--gen", "3"] if mod == "serve"
             else ["--steps", "2", "--seq", "16", "--batch", "2"])
    out = subprocess.run(
        [sys.executable, "-m", f"repro_torch.launch.{mod}", "--arch", arch, "--smoke",
         "--device", "cpu", *extra], capture_output=True, text=True, env=env, cwd=ROOT,
        timeout=300)
    assert out.returncode == 0, out.stderr
    assert ("generated 6 tokens" if mod == "serve" else "step     1") in out.stdout


def test_phase12_rehearsal_on_cpu(monkeypatch):
    """chip_smoke.py's phase 12 on the CPU at the smoke configs with its
    constants small: both models served with the frontend, gates (a)-(c)
    with their planted faults, the caught calls against the plain versions
    (themselves, here) and the training steps; launch counts stay 0."""
    import collections

    import repro_torch.configs as tconfigs

    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke

    monkeypatch.setattr(tconfigs, "get_config", tconfigs.get_smoke_config)
    for name, value in dict(
            VLM_GROUPS=2, DENSE_ROWS=2, DENSE_STEPS=3, RAG_TOP_K=1, RAG_CTX=12, RAG_PROMPT=8,
            WHISPER_REQUESTS=2, WHISPER_PROMPT=4, WHISPER_GEN=6, WHISPER_TRAIN=(2, 16),
            GATE_ROWS=2, FRONTEND_ROWS=1, FRONTEND_STEPS=3, FRONTEND_DROP=4).items():
        monkeypatch.setattr(chip_smoke, name, value)
    results = collections.defaultdict(lambda: {"launches": 0, "max_abs_err": 0.0,
                                               "checks": []})
    chip_smoke.phase_frontend(results, device="cpu")
    assert results["flash_attention_fwd"]["launches"] == 0


def test_planted_flash_faults_reach_the_kernel(monkeypatch):
    """chip_smoke.py's planted stand-ins for ``attention._flash`` (phases 6
    and 11) override the causal flag that ``apply_attention`` now passes:
    each moves a smoke model's prefill logits away from the sound ones."""
    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke
    from repro_torch.kernels.flash_attention import flash_attention_fwd

    cfg = dataclasses.replace(get_smoke_config("llama3.2-1b"), dtype="float32",
                              attn_impl="flash")
    model = tfm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.as_tensor(_tokens(cfg, (2, 16)))
    sound = tfm.make_prefill(cfg, 16)(model, tokens)[0]
    for causal, drop in ((False, 0), (True, 4)):
        monkeypatch.setattr(tattn, "_flash", chip_smoke.planted_flash(flash_attention_fwd,
                                                                      causal, drop))
        bad = tfm.make_prefill(cfg, 16)(model, tokens)[0]
        assert float((bad - sound).abs().max()) > 1e-3, (causal, drop)
