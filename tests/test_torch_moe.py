"""The port's moe family and the dense configs beyond llama3.2-1b
(``repro_torch.models.moe``, MLA and the QKV bias in
``repro_torch.models.attention``, ``dense_layers`` and the MTP head in
``repro_torch.models.transformer``) against repro's, on each arch's smoke
config with parameters carried across by ``convert.py``.

Modules: ``apply_moe`` with and without dropped tokens, ``apply_mla`` (naive
and flash) with ``apply_mla_decode``, and QKV-bias attention at fp32 (1e-4)
and bf16 (2e-2). Whole models, every new arch: forward (with the MTP
logits), aux loss, prefill and decode at fp32, naive and flash; the loss
and its gradients (aux + MTP) at fp32; the cache shapes; parameters both
ways bit for bit; and, on the port alone, teacher-forced decode against the
forward (tests/test_models_smoke.py:62). qwen2 is also held whole at
bf16. The other new archs are held at bf16 module by module only, because
the two frameworks round bf16 at other places (the SwiGLU's silu differs
by one ulp, measured) and the differences grow through the model: with
untied embeddings (deepseek-7b, starcoder2) the logits are ~4x those of a
tied model and differ by up to 0.047, past 2e-2; in the moe archs the
router then sends some token to the other of two near-tied experts
(deepseek-v3's aux 2.4827 against repro's 2.4874 at seed 0), which moves
its logits by far more than the rounding.
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
from repro.models import attention as rattn  # noqa: E402
from repro.models import moe as rmoe  # noqa: E402
from repro.models import transformer as rtfm  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    _stacked_tree,
    model_params_from_numpy,
    model_params_to_numpy,
    train_state_from_numpy,
    train_state_to_numpy,
)
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOL = {"float32": 1e-4, "bfloat16": 2e-2}  # tests/test_torch_models.py:35
DENSE = ["qwen2-1.5b", "deepseek-7b", "starcoder2-15b"]
MOE = ["kimi-k2-1t-a32b", "deepseek-v3-671b"]
L = 32  # two flash blocks of 16 in repro


def _carried(arch, dtype="float32", seed=0, **kw):
    """repro's random parameters and the port's copy of them."""
    rcfg = dataclasses.replace(r_smoke_config(arch), dtype=dtype, **kw)
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype, **kw)
    params = rtfm.init_params(jax.random.key(seed), rcfg)
    model = model_params_from_numpy(tcfg, jax.tree.map(np.asarray, params), "cpu")
    return rcfg, tcfg, params, model


def _flash(**kw):
    return dict(attn_impl="flash", flash_block_q=16, flash_block_k=16, **kw)


def _tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape).astype(np.int32)


def _x(shape, dtype, seed=3):
    x = jnp.asarray(np.random.default_rng(seed).normal(size=shape), getattr(jnp, dtype))
    return x, torch.tensor(np.asarray(x, np.float32)).to(getattr(torch, dtype))


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _layer(tree, i=0):
    return jax.tree.map(lambda a: a[i], tree)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("factor", [8.0, 0.25], ids=["no_drops", "drops"])
def test_apply_moe_matches_repro(dtype, factor):
    """B 2 x L 64 tokens, E 8, top-2 (deepseek-v3's smoke MoE with its
    shared expert); at capacity factor 0.25 (C = 8 for 32 assignments an
    expert on average) most assignments are dropped, at 8 none."""
    rcfg, tcfg, params, model = _carried("deepseek-v3-671b", dtype, capacity_factor=factor)
    assert tcfg.n_experts == 8 and tcfg.experts_per_token == 2
    x, tx = _x((2, 64, tcfg.d_model), dtype)
    want, want_aux = rmoe.apply_moe(_layer(params["layers"]["moe"]), rcfg, x)
    p = model.layers[0].moe
    assert p.router.dtype == torch.float32
    with torch.no_grad():
        got, aux = tmoe.apply_moe(p, tcfg, tx)
        _, _, ids = tmoe.route(p, tcfg, tx.reshape(-1, tcfg.d_model))
    c = tmoe.capacity(128, tcfg)
    dropped = int((tmoe.expert_slots(ids, c) >= c).sum())
    assert (dropped > 0) == (factor < 1.0), dropped
    assert got.dtype == tx.dtype and aux.dtype == torch.float32
    _close(got, want, TOL[dtype])
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)


def test_moe_routing_rules():
    """Ties go to the lowest expert; slots count assignments per expert in
    (token, rank) order and drop at C; gates are renormalised; aux is
    E * sum_e f_e P_e."""
    cfg = dataclasses.replace(get_smoke_config("kimi-k2-1t-a32b"), dtype="float32")
    moe = tmoe.MoE(cfg, torch.float32, "cpu")
    moe.init(torch.Generator().manual_seed(0), cfg)
    xf = torch.randn(5, cfg.d_model, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        moe.router.zero_()  # every expert ties
        probs, gate, ids = tmoe.route(moe, cfg, xf)
        _, aux = tmoe.apply_moe(moe, cfg, xf[None])
    assert ids.tolist() == [[0, 1]] * 5
    np.testing.assert_allclose(gate.numpy(), 0.5)
    np.testing.assert_allclose(float(aux), 1.0, rtol=1e-6)  # f = (1/2, 1/2, 0, ...), P = 1/E
    ids = torch.tensor([[3, 1], [1, 3], [1, 0], [1, 2]])
    assert tmoe.expert_slots(ids, 8).tolist() == [[0, 0], [1, 1], [2, 0], [3, 0]]


def test_ep_manual_raises_item_5():
    """ep_manual is expert parallelism over a device mesh (item 5's training
    half): off a mesh it raises rather than running the one-device program
    (tests/test_torch_lm_mesh.py holds it on meshes)."""
    cfg = dataclasses.replace(get_smoke_config("kimi-k2-1t-a32b"), moe_impl="ep_manual")
    model = tfm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="expert parallelism over a device mesh"):
        tfm.make_forward(cfg)(model, torch.zeros((1, 4), dtype=torch.int32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["naive", "flash"])
def test_apply_mla_and_decode_match_repro(dtype, impl):
    """The expanded form (naive: bottom-right mask; flash: the kernel at
    dk = hd + rh, dv = hd, scale (hd + rh) ** -0.5), the compressed cache
    it returns, and the absorbed decode at position 12 over a cache of 16,
    written in place."""
    kw = _flash() if impl == "flash" else {}
    rcfg, tcfg, params, model = _carried("deepseek-v3-671b", dtype, **kw)
    rp, tp = _layer(params["layers"]["attn"]), model.layers[0].attn
    assert isinstance(tp, tattn.MLA)
    tol = TOL[dtype]
    x, tx = _x((2, L, tcfg.d_model), dtype)
    pos = np.arange(L, dtype=np.int32)[None]
    want, wc = rattn.apply_mla(rp, rcfg, x, jnp.asarray(pos))
    with torch.no_grad():
        got, gc = tattn.apply_mla(tp, tcfg, tx, torch.as_tensor(pos))
    assert got.dtype == tx.dtype
    _close(got, want, tol)
    for key in ("ckv", "krope"):
        np.testing.assert_allclose(gc[key].float().numpy(), np.asarray(wc[key], np.float32),
                                   rtol=tol, atol=tol * 4)

    cache = {k: jnp.pad(v[:, :12], ((0, 0), (0, 4), (0, 0))) for k, v in wc.items()}
    tcache = {k: torch.tensor(np.asarray(v, np.float32)).to(tx.dtype) for k, v in cache.items()}
    x1, tx1 = _x((2, 1, tcfg.d_model), dtype, seed=4)
    want, wc = rattn.apply_mla_decode(rp, rcfg, x1, cache, jnp.int32(12))
    with torch.no_grad():
        got, gc = tattn.apply_mla_decode(tp, tcfg, tx1, tcache, 12)
    _close(got, want, tol)
    for key in ("ckv", "krope"):
        np.testing.assert_allclose(gc[key].float().numpy(), np.asarray(wc[key], np.float32),
                                   rtol=tol, atol=tol * 4)
    assert gc["ckv"] is tcache["ckv"]  # written in place
    spec = tattn.mla_cache_shape(tcfg, 3, 40)
    for key, s in rattn.mla_cache_shape(rcfg, 3, 40).items():
        assert tuple(spec[key].shape) == tuple(s.shape)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["naive", "flash"])
def test_qkv_bias_attention_matches_repro(dtype, impl):
    """qwen2's biases, set to random values in both packages (their init is
    zeros, as repro's), through the full sequence and one decode step."""
    kw = _flash() if impl == "flash" else {}
    rcfg, tcfg, params, model = _carried("qwen2-1.5b", dtype, **kw)
    rp, tp = dict(_layer(params["layers"]["attn"])), model.layers[0].attn
    assert not any(bool(getattr(tp, b).any()) for b in ("bq", "bk", "bv"))
    rng = np.random.default_rng(5)
    for b in ("bq", "bk", "bv"):
        rp[b] = jnp.asarray(rng.normal(size=rp[b].shape), getattr(jnp, dtype))
        with torch.no_grad():
            getattr(tp, b).copy_(torch.tensor(np.asarray(rp[b], np.float32)))
    tol = TOL[dtype]
    x, tx = _x((2, L, tcfg.d_model), dtype)
    pos = np.arange(L, dtype=np.int32)[None]
    want, wc = rattn.apply_attention(rp, rcfg, x, jnp.asarray(pos))
    with torch.no_grad():
        got, gc = tattn.apply_attention(tp, tcfg, tx, torch.as_tensor(pos))
    _close(got, want, tol)
    cache = {k: jnp.pad(v[:, :12], ((0, 0), (0, 4), (0, 0), (0, 0))) for k, v in wc.items()}
    tcache = {k: torch.tensor(np.asarray(v, np.float32)).to(tx.dtype) for k, v in cache.items()}
    x1, tx1 = _x((2, 1, tcfg.d_model), dtype, seed=4)
    want, _ = rattn.apply_attention_decode(rp, rcfg, x1, cache, jnp.int32(12))
    with torch.no_grad():
        got, _ = tattn.apply_attention_decode(tp, tcfg, tx1, tcache, 12)
    _close(got, want, tol)


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", DENSE + MOE)
def test_params_round_trip_and_cache_shape(arch):
    """repro -> port -> numpy gives repro's leaves bit for bit, the stacked
    ``dense_layers``, the float32 router and the unstacked MTP head among
    them, in fp32 and bf16; port -> numpy -> repro gives a tree repro runs
    to the port's logits (fp32); the cache tree matches repro's by keys,
    shapes and dtypes."""
    for dtype in ("float32", "bfloat16"):
        rcfg, tcfg, params, model = _carried(arch, dtype)
        back = model_params_to_numpy(model)
        flat_r = jax.tree_util.tree_leaves_with_path(params)
        flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
        assert len(flat_r) == len(flat_b)
        for path, leaf in flat_r:
            np.testing.assert_array_equal(flat_b[path], np.asarray(leaf, np.float32))
        got = dict(jax.tree_util.tree_leaves_with_path(tfm.cache_shape(tcfg, 3, 40),
                                                       is_leaf=lambda s: isinstance(
                                                           s, tattn.TensorSpec)))
        want = jax.tree_util.tree_leaves_with_path(rtfm.cache_shape(rcfg, 3, 40))
        assert len(got) == len(want)
        for path, s in want:
            assert tuple(got[path].shape) == tuple(s.shape)
            assert str(got[path].dtype).removeprefix("torch.") == str(s.dtype)
    own = tfm.init_params(dataclasses.replace(tcfg, dtype="float32"),
                          torch.Generator().manual_seed(4), "cpu")
    tokens = _tokens(tcfg, (2, 12))
    want, want_aux, _ = jax.jit(rtfm.make_forward(dataclasses.replace(rcfg, dtype="float32")))(
        jax.tree.map(jnp.asarray, model_params_to_numpy(own)), jnp.asarray(tokens))
    with torch.no_grad():
        got, aux, _ = tfm.make_forward(own.cfg)(own, torch.as_tensor(tokens))
    _close(got, want, TOL["float32"])
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("arch", DENSE + MOE)
@pytest.mark.parametrize("impl", ["naive", "flash"])
def test_forward_prefill_decode_match_repro(arch, impl):
    """Logits, aux loss and the MTP logits of the forward, then prefill of
    16 tokens and 16 decode steps, at fp32; qwen2 at bf16 too."""
    kw = _flash() if impl == "flash" else {}
    for dtype in ("float32",) + (("bfloat16",) if arch == "qwen2-1.5b" else ()):
        rcfg, tcfg, params, model = _carried(arch, dtype, **kw)
        tol = TOL[dtype]
        tokens = _tokens(tcfg, (2, L))
        want, want_aux, want_mtp = jax.jit(rtfm.make_forward(rcfg))(params, jnp.asarray(tokens))
        with torch.no_grad():
            got, aux, mtp = tfm.make_forward(tcfg)(model, torch.as_tensor(tokens))
        assert got.shape == (2, L, tcfg.vocab)
        _close(got, want, tol)
        np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5, atol=1e-7)
        assert (mtp is None) == (want_mtp is None) == (not tcfg.mtp)
        if tcfg.mtp:
            _close(mtp, want_mtp, tol)

        lp, cache = jax.jit(rtfm.make_prefill(rcfg, L))(params, jnp.asarray(tokens[:, :16]))
        gp, tcache = tfm.make_prefill(tcfg, L)(model, torch.as_tensor(tokens[:, :16]))
        _close(gp, lp, tol)
        assert tcache.keys() == cache.keys()
        decode = jax.jit(rtfm.make_decode_step(rcfg))
        tdecode = tfm.make_decode_step(tcfg)
        for pos in range(16, L):
            lp, cache = decode(params, jnp.asarray(tokens[:, pos]), cache, jnp.int32(pos))
            gp, tcache = tdecode(model, torch.as_tensor(tokens[:, pos]), tcache, pos)
            _close(gp, lp, tol)


@pytest.mark.parametrize("arch", DENSE + MOE)
def test_prefill_decode_matches_forward(arch):
    """Teacher-forced decode after prefill reproduces the forward logits, on
    the port alone (tests/test_models_smoke.py:62: fp32, no-drop capacity)."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32", capacity_factor=8.0)
    model = tfm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.as_tensor(_tokens(cfg, (2, L)))
    with torch.no_grad():
        full, _, _ = tfm.make_forward(cfg)(model, tokens)
    logits, cache = tfm.make_prefill(cfg, L)(model, tokens[:, :16])
    np.testing.assert_allclose(logits.numpy(), full[:, 15].numpy(), rtol=2e-3, atol=2e-3)
    decode = tfm.make_decode_step(cfg)
    for pos in range(16, L):
        logits, cache = decode(model, tokens[:, pos], cache, pos)
        np.testing.assert_allclose(logits.numpy(), full[:, pos].numpy(), rtol=5e-3, atol=5e-3)


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("impl", ["naive", "flash"])
def test_loss_and_grads_match_repro(arch, impl):
    """The loss (CE + aux + the MTP term) and its gradients at fp32 for
    every parameter, the router's and the MTP head's among them."""
    kw = _flash() if impl == "flash" else {}
    rcfg, tcfg, params, model = _carried(arch, **kw)
    tokens = _tokens(tcfg, (2, L))
    want, want_grads = jax.jit(jax.value_and_grad(rtfm.make_loss_fn(rcfg)))(
        params, {"tokens": jnp.asarray(tokens)})
    loss = tfm.make_loss_fn(tcfg)(model, {"tokens": torch.as_tensor(tokens)})
    names, leaves = zip(*model.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    got = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda t: t.float().numpy(), _stacked_tree(model, grads))))
    flat = jax.tree_util.tree_leaves_with_path(want_grads)
    assert len(flat) == len(got)
    for path, g in flat:
        np.testing.assert_allclose(got[path], np.asarray(g), rtol=1e-4, atol=1e-4,
                                   err_msg=str(path))
    if tcfg.mtp:  # the MTP term is in: without it the loss is smaller
        plain = dataclasses.replace(tcfg, mtp=False)
        with torch.no_grad():
            less = tfm.make_loss_fn(plain)(model, {"tokens": torch.as_tensor(tokens)})
        assert float(less) < float(loss.detach())


@pytest.mark.parametrize("arch", MOE)
def test_train_state_round_trip(arch):
    """A moe train state (bf16 parameters, fp32 moments, the fp32 router)
    goes repro -> port -> numpy unchanged."""
    from repro.training import optimizer as ropt

    rcfg = r_smoke_config(arch)
    rparams = rtfm.init_params(jax.random.key(1), rcfg)
    rstate = {"params": rparams, "opt": ropt.init_opt_state(rparams, ropt.OptConfig())}
    rstate["opt"]["m"] = jax.tree.map(lambda a: a + 0.5, rstate["opt"]["m"])
    state = train_state_from_numpy(get_smoke_config(arch), jax.tree.map(np.asarray, rstate), "cpu")
    assert state["params"].layers[0].moe.router.dtype == torch.float32
    back = dict(jax.tree_util.tree_leaves_with_path(train_state_to_numpy(state)))
    for path, leaf in jax.tree_util.tree_leaves_with_path(rstate):
        np.testing.assert_array_equal(back[path], np.asarray(leaf, np.float32), err_msg=str(path))


def test_launchers_run_the_moe_archs_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    for arch in MOE:
        for mod, extra in (("serve", ["--requests", "2", "--gen", "3"]),
                           ("train", ["--steps", "2", "--seq", "16", "--batch", "2"])):
            out = subprocess.run(
                [sys.executable, "-m", f"repro_torch.launch.{mod}", "--arch", arch, "--smoke",
                 "--device", "cpu", *extra], capture_output=True, text=True, env=env, cwd=ROOT,
                timeout=300)
            assert out.returncode == 0, out.stderr
            assert ("generated 6 tokens" if mod == "serve" else "step     1") in out.stdout
