"""The port's LM stack (``repro_torch.models``, ``repro_torch.configs``)
against repro's on the llama3.2-1b smoke config: parameters carried across
both ways through ``convert.py``; the layers, attention (naive, flash,
cached decode), forward, prefill and decode against repro at fp32 (1e-4:
sums in another order) and bf16 (2e-2: bf16 rounds at other places in the
two frameworks); and the port's own prefill + teacher-forced decode against
its forward, as tests/test_models_smoke.py:62 holds repro.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small tensors: threads only contend with the other workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as r_get_config  # noqa: E402
from repro.configs import get_smoke_config as r_smoke_config  # noqa: E402
from repro.models import attention as rattn  # noqa: E402
from repro.models import layers as rlayers  # noqa: E402
from repro.models import transformer as rtfm  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import model_params_from_numpy, model_params_to_numpy  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402

ARCH = "llama3.2-1b"
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _cfgs(dtype, impl="naive"):
    rcfg = dataclasses.replace(r_smoke_config(ARCH), dtype=dtype, attn_impl=impl)
    tcfg = dataclasses.replace(tconfigs.get_smoke_config(ARCH), dtype=dtype, attn_impl=impl)
    return rcfg, tcfg


def _carried(dtype, impl="naive", seed=0):
    """repro's random parameters and the port's copy of them."""
    rcfg, tcfg = _cfgs(dtype, impl)
    params = rtfm.init_params(jax.random.key(seed), rcfg)
    model = model_params_from_numpy(tcfg, jax.tree.map(np.asarray, params), "cpu")
    return rcfg, tcfg, params, model


def _tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape).astype(np.int32)


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _jx(t, dtype):
    return jnp.asarray(t.detach().float().numpy(), getattr(jnp, dtype))


# ---------------------------------------------------------------------------
# configs and parameters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", tconfigs.list_archs())
def test_configs_match_repro(arch):
    """Every arch is ported, and its published and smoke configs equal
    repro's field for field, with the same n_params and n_active_params; an
    unknown arch raises, and so does a family the config does not know."""
    assert tconfigs.list_archs() == __import__("repro.configs", fromlist=["x"]).list_archs()
    assert set(tconfigs.list_archs()) == {
        "llama3.2-1b", "starcoder2-15b", "qwen2-1.5b", "deepseek-7b", "kimi-k2-1t-a32b",
        "deepseek-v3-671b", "rwkv6-7b", "zamba2-1.2b", "llama-3.2-vision-90b",
        "whisper-large-v3"}
    for get_t, get_r in ((tconfigs.get_config, r_get_config),
                         (tconfigs.get_smoke_config, r_smoke_config)):
        t, r = get_t(arch), get_r(arch)
        assert dataclasses.asdict(t) == dataclasses.asdict(r)
        assert t.n_params == r.n_params and t.n_active_params == r.n_active_params
    with pytest.raises(KeyError):
        tconfigs.get_config("gpt-2")
    with pytest.raises(AssertionError):
        dataclasses.replace(tconfigs.get_smoke_config(ARCH), family="retnet")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_round_trip_both_ways(dtype):
    """repro -> port -> numpy gives repro's leaves bit for bit (bf16 through
    fp32 is exact); port -> numpy -> repro gives a tree repro runs to the
    port's logits."""
    rcfg, tcfg, params, model = _carried(dtype)
    back = model_params_to_numpy(model)
    flat_r = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_r) == len(flat_b)
    for path, leaf in flat_r:
        np.testing.assert_array_equal(flat_b[path], np.asarray(leaf, np.float32))

    own = tfm.init_params(tcfg, torch.Generator().manual_seed(4), "cpu")
    tree = jax.tree.map(lambda a: jnp.asarray(a, getattr(jnp, dtype)), model_params_to_numpy(own))
    tokens = _tokens(tcfg, (2, 12))
    want, _, _ = jax.jit(rtfm.make_forward(rcfg))(tree, jnp.asarray(tokens))
    with torch.no_grad():
        got, _, _ = tfm.make_forward(tcfg)(own, torch.as_tensor(tokens))
    _close(got, want, TOL[dtype])


def test_init_params_uses_repros_scales():
    """The port's draws differ from jax.random's, their scales do not."""
    rcfg, tcfg = _cfgs("float32")
    rcfg = dataclasses.replace(rcfg, n_layers=8)
    tcfg = dataclasses.replace(tcfg, n_layers=8)
    want = jax.tree_util.tree_leaves_with_path(rtfm.init_params(jax.random.key(0), rcfg))
    got = dict(jax.tree_util.tree_leaves_with_path(model_params_to_numpy(
        tfm.init_params(tcfg, torch.Generator().manual_seed(0), "cpu"))))
    for path, leaf in want:
        r, t = np.asarray(leaf), got[path]
        assert r.shape == t.shape
        np.testing.assert_allclose(t.std(), r.std(), rtol=0.1, atol=1e-7, err_msg=str(path))
        np.testing.assert_allclose(t.mean(), r.mean(), atol=0.1 * r.std() + 1e-7)


def test_init_params_defaults_to_cuda():
    """``device=None`` means CUDA: without a card it raises; with one, a CPU
    generator does not match it."""
    cfg = tconfigs.get_smoke_config(ARCH)
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="generator"):
            tfm.init_params(cfg, torch.Generator(), None)
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tfm.init_params(cfg, torch.Generator(), None)


# ---------------------------------------------------------------------------
# layers and attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layers_match_repro(dtype):
    rng = np.random.default_rng(2)
    tdt = getattr(torch, dtype)
    x = torch.tensor(rng.normal(size=(2, 7, 64)).astype(np.float32)).to(tdt)
    scale = torch.tensor(rng.normal(1.0, 0.2, size=64).astype(np.float32)).to(tdt)
    norm = tlayers.RMSNorm(64, tdt, "cpu")
    with torch.no_grad():
        norm.scale.copy_(scale)
    got = tlayers.rms_norm(norm, x)
    assert got.dtype == tdt
    _close(got, rlayers.rms_norm({"scale": _jx(scale, dtype)}, _jx(x, dtype)), TOL[dtype])

    xr = torch.tensor(rng.normal(size=(2, 7, 3, 32)).astype(np.float32)).to(tdt)
    pos = torch.tensor([[0, 1, 2, 3, 100, 1000, 1087]], dtype=torch.int32)
    got = tlayers.apply_rope(xr, pos, 500_000.0)
    assert got.dtype == tdt
    _close(got, rlayers.apply_rope(_jx(xr, dtype), jnp.asarray(pos.numpy()), 500_000.0),
           TOL[dtype])

    mlp = tlayers.MLP(64, 96, tdt, "cpu")
    mlp.init(torch.Generator().manual_seed(0))
    rp = {k: _jx(getattr(mlp, k), dtype) for k in ("w_gate", "w_up", "w_down")}
    _close(tlayers.apply_mlp(mlp, x), rlayers.apply_mlp(rp, _jx(x, dtype)), TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["naive", "flash"])
def test_attention_matches_repro(dtype, impl):
    rcfg, tcfg, params, model = _carried(dtype, impl)
    rp = jax.tree.map(lambda a: a[0], params["layers"]["attn"])
    tp = model.layers[0].attn
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.normal(size=(2, 12, tcfg.d_model)), getattr(jnp, dtype))
    tx = torch.tensor(np.asarray(x, np.float32)).to(getattr(torch, dtype))
    pos = np.arange(12, dtype=np.int32)[None]
    want, wc = rattn.apply_attention(rp, rcfg, x, jnp.asarray(pos))
    with torch.no_grad():
        got, gc = tattn.apply_attention(tp, tcfg, tx, torch.as_tensor(pos))
    assert got.dtype == tx.dtype
    _close(got, want, TOL[dtype])
    for key in ("k", "v"):  # projections: relative to their magnitude
        np.testing.assert_allclose(gc[key].float().numpy(), np.asarray(wc[key], np.float32),
                                   rtol=TOL[dtype], atol=TOL[dtype] * 4)

    # single-token decode at position 12 over a cache of 16
    cache = {k: jnp.pad(v, ((0, 0), (0, 4), (0, 0), (0, 0))) for k, v in wc.items()}
    tcache = {k: torch.tensor(np.asarray(v, np.float32)).to(tx.dtype) for k, v in cache.items()}
    x1 = jnp.asarray(rng.normal(size=(2, 1, tcfg.d_model)), getattr(jnp, dtype))
    want, wc = rattn.apply_attention_decode(rp, rcfg, x1, cache, jnp.int32(12))
    with torch.no_grad():
        got, gc = tattn.apply_attention_decode(
            tp, tcfg, torch.tensor(np.asarray(x1, np.float32)).to(tx.dtype), tcache, 12)
    _close(got, want, TOL[dtype])
    np.testing.assert_allclose(gc["k"].float().numpy(), np.asarray(wc["k"], np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype] * 4)
    assert gc["k"] is tcache["k"]  # written in place


def test_cache_shape_matches_repro():
    rcfg, tcfg = _cfgs("bfloat16")
    want = rtfm.cache_shape(rcfg, 3, 40)["layers"]
    got = tfm.cache_shape(tcfg, 3, 40)["layers"]
    for k in ("k", "v"):
        assert tuple(got[k].shape) == tuple(want[k].shape)
        assert got[k].dtype == torch.bfloat16 and want[k].dtype == jnp.bfloat16
    spec = tattn.kv_cache_shape(tcfg, 3, 40)["k"]
    assert tuple(spec.shape) == tuple(rattn.kv_cache_shape(rcfg, 3, 40)["k"].shape)


# ---------------------------------------------------------------------------
# forward, prefill, decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["naive", "flash"])
def test_forward_prefill_decode_match_repro(dtype, impl):
    rcfg, tcfg, params, model = _carried(dtype, impl)
    tol = TOL[dtype]
    tokens = _tokens(tcfg, (2, 24))
    want, _, _ = jax.jit(rtfm.make_forward(rcfg))(params, jnp.asarray(tokens))
    with torch.no_grad():
        got, aux, mtp = tfm.make_forward(tcfg)(model, torch.as_tensor(tokens))
    assert got.shape == (2, 24, tcfg.vocab) and mtp is None and float(aux) == 0.0
    _close(got, want, tol)

    lp, cache = jax.jit(rtfm.make_prefill(rcfg, 32))(params, jnp.asarray(tokens[:, :16]))
    gp, tcache = tfm.make_prefill(tcfg, 32)(model, torch.as_tensor(tokens[:, :16]))
    _close(gp, lp, tol)
    assert tuple(tcache["layers"]["k"].shape) == tuple(cache["layers"]["k"].shape)
    assert not bool(tcache["layers"]["k"][:, :, 16:].any())  # padded to max_len with zeros
    decode = jax.jit(rtfm.make_decode_step(rcfg))
    tdecode = tfm.make_decode_step(tcfg)
    for pos in range(16, 24):
        lp, cache = decode(params, jnp.asarray(tokens[:, pos]), cache, jnp.int32(pos))
        gp, tcache = tdecode(model, torch.as_tensor(tokens[:, pos]), tcache, pos)
        _close(gp, lp, tol)


@pytest.mark.parametrize("impl", ["naive", "flash"])
def test_prefill_decode_matches_forward(impl):
    """Teacher-forced decode after prefill reproduces the forward logits
    (tests/test_models_smoke.py:62, on the port alone)."""
    _, cfg = _cfgs("float32", impl)
    model = tfm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.as_tensor(_tokens(cfg, (2, 16)))
    with torch.no_grad():
        full, _, _ = tfm.make_forward(cfg)(model, tokens)
    logits, cache = tfm.make_prefill(cfg, 16)(model, tokens[:, :8])
    np.testing.assert_allclose(logits.numpy(), full[:, 7].numpy(), rtol=2e-3, atol=2e-3)
    decode = tfm.make_decode_step(cfg)
    for pos in range(8, 16):
        logits, cache = decode(model, tokens[:, pos], cache, pos)
        np.testing.assert_allclose(logits.numpy(), full[:, pos].numpy(), rtol=2e-3, atol=2e-3)
