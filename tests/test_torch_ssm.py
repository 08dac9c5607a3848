"""The port's recurrent families (``repro_torch.models.rwkv6``,
``repro_torch.models.mamba2`` and the ssm and hybrid branches of
``repro_torch.models.transformer``) against repro's, on numpy inputs from a
seed and on the rwkv6-7b and zamba2-1.2b smoke configs with parameters
carried across by ``convert.py``.

Tolerances: the scan cores at 2e-4 (tests/test_ssm_cores.py's, fp32 sums
of a chunk's products in another order), their per-step forms at 1e-5;
blocks and whole models at fp32 1e-4 (tests/test_torch_models.py:35);
blocks at bf16 2e-2 of the largest |value| of each tensor: the two
frameworks round bf16 at other places (XLA's CPU sigmoid rounds each of its
three steps to bf16, PyTorch's once: a third of the values one ulp apart,
measured), and one ulp of a block's intermediates (0.03 at 4-8, the outputs
reach 5.5) lands on outputs near 0 after the residual add; gradients 1e-4
of each leaf's largest |value| (the embedding's reach 4.3 through zamba2's
scans, and the two frameworks' fp32 sums, in other orders, part by ~5e-5 of
that, measured). Whole models are held at fp32 only: at bf16 one ulp in a
projection grows through the layers (0.18 for rwkv6's smoke logits, 0.51
for zamba2's, measured), as tests/test_torch_moe.py found for the dense
archs.
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
from repro.models import mamba2 as rmamba  # noqa: E402
from repro.models import rwkv6 as rrwkv  # noqa: E402
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
from repro_torch.models import mamba2 as tmamba  # noqa: E402
from repro_torch.models import rwkv6 as trwkv  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["rwkv6-7b", "zamba2-1.2b"]
TOL = {"float32": 1e-4, "bfloat16": 2e-2}  # tests/test_torch_models.py:35
CORE_TOL = 2e-4  # tests/test_ssm_cores.py:35
L = 32  # two chunks of the smoke configs' ssm_chunk 16


def _carried(arch, dtype="float32", seed=0, **kw):
    """repro's random parameters and the port's copy of them."""
    rcfg = dataclasses.replace(r_smoke_config(arch), dtype=dtype, **kw)
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype, **kw)
    params = rtfm.init_params(jax.random.key(seed), rcfg)
    model = model_params_from_numpy(tcfg, jax.tree.map(np.asarray, params), "cpu")
    return rcfg, tcfg, params, model


def _tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape).astype(np.int32)


def _t(a):
    """A jax array as a torch tensor of the same dtype."""
    return torch.tensor(np.asarray(a, np.float32)).to(getattr(torch, str(a.dtype)))


def _close(got, want, tol, scaled: bool = False):
    """|got - want| <= tol + tol |want|; ``scaled``: tol max |want| + tol |want|."""
    want = np.asarray(want, np.float32)
    atol = tol * max(1.0, float(np.abs(want).max())) if scaled else tol
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=tol, atol=atol)


def _wkv_inputs(rng, b, l, h, k, w_lo=0.5, w_hi=0.999):
    """tests/test_ssm_cores.py's draws, with a random incoming state."""
    f = lambda *s: jnp.asarray(rng.normal(size=s), jnp.float32)
    w = jnp.asarray(rng.uniform(w_lo, w_hi, size=(b, l, h, k)), jnp.float32)
    return f(b, l, h, k), f(b, l, h, k), f(b, l, h, k), w, f(h, k), f(b, h, k, k)


def _ssd_inputs(rng, b, l, h, p, n):
    f = lambda *s: jnp.asarray(rng.normal(size=s), jnp.float32)
    dt = jnp.asarray(np.abs(rng.normal(0.5, 0.2, size=(b, l, h))), jnp.float32)
    a_neg = -jnp.asarray(np.abs(rng.normal(1.0, 0.5, size=(h,))), jnp.float32)
    return f(b, l, h, p), dt, a_neg, f(b, l, n), f(b, l, n), f(b, h, p, n)


# ---------------------------------------------------------------------------
# the scan cores
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk,l", [(8, 32), (16, 64), (16, 16), (64, 128)])
def test_wkv6_forms_match_repro(chunk, l):
    """wkv6_chunked and wkv6_scan against repro's (outputs and final state,
    2e-4), and wkv6_step one step at a time against repro's step (1e-5), at
    tests/test_ssm_cores.py's (chunk, L) grid plus rwkv6-7b's chunk 64."""
    ins = _wkv_inputs(np.random.default_rng(l + chunk), 2, l, 3, 8)
    tins = [_t(a) for a in ins]
    for r_fn, t_fn, kw in ((rrwkv.wkv6_chunked, trwkv.wkv6_chunked, {"chunk": chunk}),
                           (rrwkv.wkv6_scan, trwkv.wkv6_scan, {})):
        want_y, want_s = r_fn(*ins, **kw)
        got_y, got_s = t_fn(*tins, **kw)
        assert got_y.dtype == got_s.dtype == torch.float32
        _close(got_y, want_y, CORE_TOL)
        _close(got_s, want_s, CORE_TOL)
    r, k, v, w, u, s = ins
    ts = tins[5]
    for t in range(4):
        want_y, s = rrwkv.wkv6_step(r[:, t], k[:, t], v[:, t], w[:, t], u, s)
        got_y, ts = trwkv.wkv6_step(*(a[:, t] for a in tins[:4]), tins[4], ts)
        _close(got_y, want_y, 1e-5)
        _close(ts, s, 1e-5)
    with pytest.raises(ValueError, match="multiple of chunk"):
        trwkv.wkv6_chunked(*(a[:, :l - 1] for a in tins[:4]), tins[4], tins[5], chunk)


@pytest.mark.parametrize("chunk,exact", [(16, True), (64, False)])
def test_wkv6_chunked_reproduces_repros_chunk64_strong_decay_fault(chunk, exact):
    """repro's fault, pinned (ROADMAP Queue 3): at decays in [0.05, 0.3] a
    chunk's cumulative log decay passes 2 x EXP_CLAMP = 80 within 64 steps,
    the two clamped factors of ``wkv6_chunked`` no longer multiply to
    exp(lexc_t - lc_s), and near-diagonal terms come out as 1. At chunk 64
    (rwkv6-7b's ssm_chunk) the port's chunked form equals repro's, and both
    are off from the exact scan by more than 1 (~29 at these draws: L 128,
    B 1, H 2, K 8); at chunk 16 all three agree (tests/test_ssm_cores.py's
    case, 1e-3)."""
    ins = _wkv_inputs(np.random.default_rng(3), 1, 128, 2, 8, w_lo=0.05, w_hi=0.3)
    ins = ins[:5] + (jnp.zeros((1, 2, 8, 8), jnp.float32),)
    tins = [_t(a) for a in ins]
    want, _ = rrwkv.wkv6_chunked(*ins, chunk=chunk)
    got, _ = trwkv.wkv6_chunked(*tins, chunk=chunk)
    exact_y, _ = trwkv.wkv6_scan(*tins)
    assert bool(torch.isfinite(got).all())
    _close(got, want, CORE_TOL)
    gap = float((got - exact_y).abs().max())
    want_gap = float(np.abs(np.asarray(want) - exact_y.numpy()).max())
    if exact:
        assert gap < 1e-3 and want_gap < 1e-3, (gap, want_gap)
    else:
        assert gap > 1.0 and want_gap > 1.0, (gap, want_gap)


@pytest.mark.parametrize("chunk,l", [(8, 32), (16, 64), (64, 128)])
def test_ssd_forms_match_repro(chunk, l):
    """ssd_chunked and ssd_scan against repro's, outputs and final state
    (2e-4), from a random incoming state."""
    ins = _ssd_inputs(np.random.default_rng(l + 1), 2, l, 3, 8, 8)
    tins = [_t(a) for a in ins]
    for r_fn, t_fn, args in ((rmamba.ssd_chunked, tmamba.ssd_chunked, (chunk,)),
                             (rmamba.ssd_scan, tmamba.ssd_scan, ())):
        want_y, want_s = r_fn(*ins, *args)
        got_y, got_s = t_fn(*tins, *args)
        _close(got_y, want_y, CORE_TOL)
        _close(got_s, want_s, CORE_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_matches_repro(dtype):
    """The depthwise causal conv over a sequence (from a non-zero state) and
    one step of it, against repro's ``_causal_conv_seq`` / ``_causal_conv_step``;
    the step form equals the sequence form at L = 1."""
    rng = np.random.default_rng(7)
    jt = getattr(jnp, dtype)
    f = lambda *s: jnp.asarray(rng.normal(size=s), jt)
    w, b, x, st = f(tmamba.CONV_W, 24), f(24), f(2, 12, 24), f(2, tmamba.CONV_W - 1, 24)
    want_y, want_s = rmamba._causal_conv_seq(w, b, x, st)
    got_y, got_s = tmamba._causal_conv_seq(_t(w), _t(b), _t(x), _t(st))
    assert got_y.dtype == getattr(torch, dtype)
    _close(got_y, want_y, TOL[dtype])
    _close(got_s, want_s, 0.0)
    want_y, want_s = rmamba._causal_conv_step(w, b, x[:, 0], st)
    got_y, got_s = tmamba._causal_conv_step(_t(w), _t(b), _t(x[:, 0]), _t(st))
    _close(got_y, want_y, TOL[dtype])
    _close(got_s, want_s, 0.0)
    seq_y, seq_s = tmamba._causal_conv_seq(_t(w), _t(b), _t(x[:, :1]), _t(st))
    assert torch.equal(seq_y[:, 0], got_y) and torch.equal(seq_s, got_s)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def _block_state(spec, rng):
    """A non-zero incoming state in repro's dtypes."""
    return {k: jnp.asarray(rng.normal(size=s.shape) * 0.5, s.dtype) for k, s in spec.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunked", [True, False], ids=["chunked", "scan"])
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_block_matches_repro(arch, dtype, chunked):
    """``apply_rwkv6_block`` / ``apply_mamba2_block`` over L 32 from a
    non-zero incoming state, the chunked form and the per-step one: the
    output and every leaf of the outgoing state."""
    rcfg, tcfg, params, model = _carried(arch, dtype)
    rng = np.random.default_rng(11)
    rp, tp = jax.tree.map(lambda a: a[1], params["layers"]), model.layers[1]
    if arch == "rwkv6-7b":
        r_apply, t_apply, spec = (rrwkv.apply_rwkv6_block, trwkv.apply_rwkv6_block,
                                  rrwkv.rwkv6_state_shape(rcfg, 2))
    else:
        r_apply, t_apply, spec = (rmamba.apply_mamba2_block, tmamba.apply_mamba2_block,
                                  rmamba.mamba2_state_shape(rcfg, 2))
    state = _block_state(spec, rng)
    x = jnp.asarray(rng.normal(size=(2, L, tcfg.d_model)), getattr(jnp, dtype))
    want, want_state = r_apply(rp, rcfg, x, state, chunked=chunked)
    with torch.no_grad():
        got, got_state = t_apply(tp, tcfg, _t(x), {k: _t(v) for k, v in state.items()},
                                 chunked=chunked)
    assert got.dtype == getattr(torch, dtype)
    bf16 = dtype == "bfloat16"
    _close(got, want, TOL[dtype], scaled=bf16)
    assert got_state.keys() == want_state.keys()
    for key, s in want_state.items():
        assert got_state[key].dtype == getattr(torch, str(s.dtype)), key
        _close(got_state[key], s, TOL[dtype], scaled=bf16)


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------


def _cache_specs(cfg, b, max_len):
    return dict(jax.tree_util.tree_leaves_with_path(
        tfm.cache_shape(cfg, b, max_len), is_leaf=lambda s: isinstance(s, tattn.TensorSpec)))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_decode_match_repro(arch):
    """At fp32: the forward's logits (aux 0), prefill of 16 tokens (its
    logits and the cache tree, leaf by leaf, equal to repro's state tree)
    and 4 decode steps, each step's logits and the state after the last."""
    rcfg, tcfg, params, model = _carried(arch)
    tokens = _tokens(tcfg, (2, L))
    want, want_aux, _ = jax.jit(rtfm.make_forward(rcfg))(params, jnp.asarray(tokens))
    with torch.no_grad():
        got, aux, mtp = tfm.make_forward(tcfg)(model, torch.as_tensor(tokens))
    assert got.shape == (2, L, tcfg.vocab) and mtp is None
    _close(got, want, TOL["float32"])
    assert float(aux) == float(want_aux) == 0.0

    lp, cache = jax.jit(rtfm.make_prefill(rcfg, L))(params, jnp.asarray(tokens[:, :16]))
    gp, tcache = tfm.make_prefill(tcfg, L)(model, torch.as_tensor(tokens[:, :16]))
    _close(gp, lp, TOL["float32"])

    def same_tree(tc, c):
        flat = jax.tree_util.tree_leaves_with_path(c)
        got_flat = dict(jax.tree_util.tree_leaves_with_path(tc))
        assert len(flat) == len(got_flat)
        for path, leaf in flat:
            assert tuple(got_flat[path].shape) == leaf.shape, path
            _close(got_flat[path], leaf, TOL["float32"])

    same_tree(tcache, cache)
    decode = jax.jit(rtfm.make_decode_step(rcfg))
    tdecode = tfm.make_decode_step(tcfg)
    for pos in range(16, 20):
        lp, cache = decode(params, jnp.asarray(tokens[:, pos]), cache, jnp.int32(pos))
        gp, tcache = tdecode(model, torch.as_tensor(tokens[:, pos]), tcache, pos)
        _close(gp, lp, TOL["float32"])
    same_tree(tcache, cache)


@pytest.mark.parametrize("l", [20, 1], ids=["L20", "L1"])
@pytest.mark.parametrize("arch", ARCHS)
def test_lengths_off_the_chunk(arch, l):
    """An L that is not a multiple of ssm_chunk (20 with chunk 16) and L = 1
    take the per-step scan in both packages: forward and prefill logits."""
    rcfg, tcfg, params, model = _carried(arch)
    tokens = _tokens(tcfg, (2, l), seed=5)
    want, _, _ = jax.jit(rtfm.make_forward(rcfg))(params, jnp.asarray(tokens))
    with torch.no_grad():
        got, _, _ = tfm.make_forward(tcfg)(model, torch.as_tensor(tokens))
    _close(got, want, TOL["float32"])
    lp, _ = jax.jit(rtfm.make_prefill(rcfg, 24))(params, jnp.asarray(tokens))
    gp, _ = tfm.make_prefill(tcfg, 24)(model, torch.as_tensor(tokens))
    _close(gp, lp, TOL["float32"])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_forward(arch):
    """Teacher-forced decode after a chunked prefill reproduces the forward
    logits, on the port alone (tests/test_models_smoke.py:62's check, fp32);
    the decode steps overwrite the recurrent state in place."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    model = tfm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.as_tensor(_tokens(cfg, (2, L)))
    with torch.no_grad():
        full, _, _ = tfm.make_forward(cfg)(model, tokens)
    logits, cache = tfm.make_prefill(cfg, L)(model, tokens[:, :16])
    np.testing.assert_allclose(logits.numpy(), full[:, 15].numpy(), rtol=2e-3, atol=2e-3)
    ptrs = {(g, k): t.data_ptr() for g, tree in cache.items() for k, t in tree.items()}
    decode = tfm.make_decode_step(cfg)
    for pos in range(16, L):
        logits, cache = decode(model, tokens[:, pos], cache, pos)
        np.testing.assert_allclose(logits.numpy(), full[:, pos].numpy(), rtol=5e-3, atol=5e-3)
    assert ptrs == {(g, k): t.data_ptr() for g, tree in cache.items() for k, t in tree.items()}


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_repro(arch, remat):
    """The loss (aux 0) and the gradient of every parameter at fp32 (1e-4 of
    the leaf's largest |value|),
    the float32 w0 / u / a_log / d_skip / dt_bias and the shared block's
    among them; under remat "full" zamba2 recomputes whole groups."""
    rcfg, tcfg, params, model = _carried(arch, remat=remat)
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
        _close(torch.tensor(got[path]), g, 1e-4, scaled=True)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_train_state_and_cache_shape(arch):
    """Parameters repro -> port -> numpy bit for bit at fp32 and bf16 (the
    float32 leaves stay float32); a train state (bf16 parameters, fp32
    moments) the same; the cache tree matches repro's by keys, shapes and
    dtypes, and its recurrent leaves do not grow with max_len."""
    from repro.training import optimizer as ropt

    for dtype in ("float32", "bfloat16"):
        rcfg, tcfg, params, model = _carried(arch, dtype)
        back = dict(jax.tree_util.tree_leaves_with_path(model_params_to_numpy(model)))
        flat = jax.tree_util.tree_leaves_with_path(params)
        assert len(flat) == len(back)
        for path, leaf in flat:
            np.testing.assert_array_equal(back[path], np.asarray(leaf, np.float32))
        for max_len in (40, 80):
            got = _cache_specs(tcfg, 3, max_len)
            want = jax.tree_util.tree_leaves_with_path(rtfm.cache_shape(rcfg, 3, max_len))
            assert len(got) == len(want)
            for path, s in want:
                assert tuple(got[path].shape) == tuple(s.shape), path
                assert str(got[path].dtype).removeprefix("torch.") == str(s.dtype)
    recurrent = lambda specs: {p: s for p, s in specs.items() if "shared" not in str(p)}
    assert recurrent(_cache_specs(tcfg, 3, 40)) == recurrent(_cache_specs(tcfg, 3, 4000))
    blk = model.layers[0]
    f32 = ([blk.tm.w0, blk.tm.u] if arch == "rwkv6-7b"
           else [blk.a_log, blk.d_skip, blk.dt_bias])
    assert all(p.dtype == torch.float32 for p in f32)

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
    not (w0 centred at -6, a_log = log(linspace(1, 16, H)) exactly): over a
    leaf of n draws, two samples' stds part by ~std / sqrt(n) and their
    means by ~std sqrt(2 / n), so each is held within 4 of those (the
    smallest leaves have 256 draws) and 2% of the std."""
    rcfg = dataclasses.replace(r_smoke_config(arch), dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    want = jax.tree_util.tree_leaves_with_path(rtfm.init_params(jax.random.key(0), rcfg))
    got = dict(jax.tree_util.tree_leaves_with_path(model_params_to_numpy(
        tfm.init_params(tcfg, torch.Generator().manual_seed(0), "cpu"))))
    assert len(want) == len(got)
    for path, leaf in want:
        r, t = np.asarray(leaf), got[path]
        assert r.shape == t.shape, path
        if "a_log" in str(path):
            np.testing.assert_allclose(t, r, rtol=1e-6)
        np.testing.assert_allclose(t.std(), r.std(), rtol=0.02 + 4.0 / np.sqrt(r.size),
                                   atol=1e-6, err_msg=str(path))
        np.testing.assert_allclose(t.mean(), r.mean(),
                                   atol=(0.02 + 4.0 * np.sqrt(2.0 / r.size)) * r.std() + 1e-6,
                                   err_msg=str(path))


@pytest.mark.parametrize("arch", ARCHS)
def test_launchers_serve_rag_and_train_on_cpu(arch):
    """``launch.serve --rag`` and ``launch.train`` run the smoke config on
    the CPU."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    for mod, extra in (("serve", ["--requests", "2", "--gen", "3", "--rag"]),
                       ("train", ["--steps", "2", "--seq", "16", "--batch", "2"])):
        out = subprocess.run(
            [sys.executable, "-m", f"repro_torch.launch.{mod}", "--arch", arch, "--smoke",
             "--device", "cpu", *extra], capture_output=True, text=True, env=env, cwd=ROOT,
            timeout=300)
        assert out.returncode == 0, out.stderr
        assert ("generated 6 tokens" if mod == "serve" else "step     1") in out.stdout
        if mod == "serve":
            assert "RAG: retrieved top-2" in out.stdout
