"""The port's flash attention (plain versions, the CPU side of
``flash_attention_fwd`` and ``flash_attention_bwd``) against repro's Pallas
``_flash_fwd`` and ``_flash_bwd`` in interpret mode: out and LSE over the
shape sweep of tests/test_flash_attention.py, causal and not, fp32 and bf16,
with that file's tolerances (1e-5 fp32, 2e-2 bf16), and dQ, dK, dV at its
gradient tolerance (2e-4). Also: the top-left causal mask at L != S; tail
lengths (L not a multiple of the block), where repro's kernels give NaN,
held against ``ref_attention`` and its ``jax.grad`` and against repro's
naive model path; gradcheck in float64; the autograd wrapper. The CUDA
kernels against these plain versions are in tests/test_torch_gpu.py.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as r_smoke_config  # noqa: E402
from repro.kernels.flash_attention import _flash_bwd, _flash_fwd, ref_attention  # noqa: E402
from repro.models import transformer as rtfm  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import model_params_from_numpy  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    NEG_INF,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_attention_bwd_plain,
    flash_attention_fwd,
    flash_attention_plain,
)
from repro_torch.models import transformer as tfm  # noqa: E402

# tests/test_flash_attention.py:17-24
CASES = [
    # (B, H, KV, L, S, dk, dv, bq, bk)
    (1, 1, 1, 16, 16, 8, 8, 8, 8),
    (2, 4, 2, 64, 64, 32, 32, 32, 32),
    (1, 8, 2, 128, 128, 64, 64, 64, 32),  # GQA g=4, uneven blocks
    (2, 2, 2, 96, 96, 48, 32, 32, 48),  # dk != dv (MLA-style)
    (1, 4, 4, 64, 128, 32, 32, 64, 64),  # cross: S > L
]
TOL = {"float32": 1e-5, "bfloat16": 2e-2}  # tests/test_flash_attention.py:40


def _qkv(b, h, kv, l, s, dk, dv, seed, dtype):
    rng = np.random.default_rng(seed)
    arrays = (rng.normal(size=(b, h, l, dk)), rng.normal(size=(b, kv, s, dk)),
              rng.normal(size=(b, kv, s, dv)))
    jx = tuple(jnp.asarray(a, getattr(jnp, dtype)) for a in arrays)
    # the same (rounded) values on both sides
    th = tuple(torch.tensor(np.asarray(a, np.float32)).to(getattr(torch, dtype)) for a in jx)
    return jx, th


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _ref_lse(q, k, causal_top_left, scale):
    """Row log-sum-exp of the masked scores, in jnp (fp32)."""
    b, h, l, dk = q.shape
    kvh, s = k.shape[1], k.shape[2]
    qg = q.reshape(b, kvh, h // kvh, l, dk).astype(jnp.float32)
    sc = jnp.einsum("bkgld,bksd->bkgls", qg, k.astype(jnp.float32)) * scale
    if causal_top_left:
        mask = jnp.arange(l)[:, None] >= jnp.arange(s)[None, :]
        sc = jnp.where(mask, sc, NEG_INF)
    return jax.nn.logsumexp(sc, axis=-1).reshape(b, h, l)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_interpret(case, causal, dtype):
    b, h, kv, l, s, dk, dv, bq, bk = case
    if causal and l != s:
        pytest.skip("causal assumes L == S here")
    (q, k, v), (tq, tk, tv) = _qkv(b, h, kv, l, s, dk, dv, sum(case), dtype)
    scale = dk**-0.5
    out, lse = _flash_fwd(q, k, v, causal=causal, sm_scale=scale, block_q=bq, block_k=bk,
                          interpret=True)
    got_out, got_lse = flash_attention_fwd(tq, tk, tv, causal, scale)
    assert got_out.dtype == tq.dtype and got_lse.dtype == torch.float32
    assert got_out.shape == (b, h, l, dv) and got_lse.shape == (b, h, l)
    _close(got_out, out, TOL[dtype])
    _close(got_lse, lse, TOL[dtype])


def test_causal_mask_is_top_left():
    """At L = 32, S = 64 the kernel's mask is row >= col (top-left), not
    ref_attention's tril(k = S - L): the port keeps the kernel's."""
    (q, k, v), (tq, tk, tv) = _qkv(1, 4, 2, 32, 64, 16, 16, 5, "float32")
    out, lse = _flash_fwd(q, k, v, causal=True, sm_scale=0.25, block_q=16, block_k=16,
                          interpret=True)
    got_out, got_lse = flash_attention_plain(tq, tk, tv, True, 0.25)
    _close(got_out, out, 1e-5)
    _close(got_lse, lse, 1e-5)
    bottom_right = ref_attention(q, k, v, causal=True, sm_scale=0.25)
    assert np.abs(got_out.numpy() - np.asarray(bottom_right)).max() > 0.1


@pytest.mark.parametrize("l", [40, 1088])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tail_lengths_match_ref_attention(l, dtype):
    """L = S not a multiple of the block (40 vs 16, 1088 vs 512): repro's
    Pallas kernel returns NaN in the tail block there (ROADMAP Queue 3); the
    port's result does not depend on tiles and equals ref_attention."""
    (q, k, v), (tq, tk, tv) = _qkv(1, 2, 1, l, l, 16, 16, l, dtype)
    for causal in (True, False):
        got_out, got_lse = flash_attention(tq, tk, tv, causal)
        assert bool(torch.isfinite(got_out.float()).all())
        _close(got_out, ref_attention(q, k, v, causal=causal), TOL[dtype])
        _close(got_lse, _ref_lse(q, k, causal, 16**-0.5), TOL[dtype])


def test_flash_model_path_equals_repro_naive_at_tail_length():
    """The whole smoke model at L = 40 with flash attention equals repro's
    naive path (fp32, 1e-4), where repro's flash path with blocks of 16
    gives NaN logits."""
    rcfg = dataclasses.replace(r_smoke_config("llama3.2-1b"), dtype="float32")
    cfg = dataclasses.replace(get_smoke_config("llama3.2-1b"), dtype="float32",
                              attn_impl="flash", flash_block_q=16, flash_block_k=16)
    params = rtfm.init_params(jax.random.key(0), rcfg)
    model = model_params_from_numpy(cfg, jax.tree.map(np.asarray, params), "cpu")
    tokens = np.random.default_rng(3).integers(0, cfg.vocab, (2, 40)).astype(np.int32)
    want, _, _ = jax.jit(rtfm.make_forward(rcfg))(params, jnp.asarray(tokens))
    with torch.no_grad():
        got, _, _ = tfm.make_forward(cfg)(model, torch.as_tensor(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_default_scale_and_autograd_wrapper():
    """``flash_attention`` defaults to dk ** -0.5, returns (out, lse), and
    its backward is ``flash_attention_bwd`` on the saved (q, k, v, out, lse);
    the two per-kernel wrappers give the same pieces."""
    _, (tq, tk, tv) = _qkv(1, 2, 2, 8, 8, 16, 8, 1, "float32")
    out, lse = flash_attention(tq, tk, tv, True)
    want_out, want_lse = flash_attention_plain(tq, tk, tv, True, 16**-0.5)
    assert torch.equal(out, want_out) and torch.equal(lse, want_lse)
    for t in (tq, tk, tv):
        t.requires_grad_(True)
    out, lse = flash_attention(tq, tk, tv, True)
    assert not lse.requires_grad
    dout = torch.randn(out.shape, generator=torch.Generator().manual_seed(0))
    out.backward(dout)
    want = flash_attention_bwd_plain(tq, tk, tv, out.detach(), lse, dout, True, 16**-0.5)
    assert all(torch.equal(t.grad, w) for t, w in zip((tq, tk, tv), want))
    with torch.no_grad():
        got = flash_attention_bwd(tq, tk, tv, out, lse, dout, True)
        delta = (dout * out).sum(-1)
        dq = flash_attention_bwd_dq(tq, tk, tv, dout, lse, delta, True)
        dk, dv = flash_attention_bwd_dkv(tq, tk, tv, dout, lse, delta, True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(torch.equal(a, b) for a, b in zip((dq, dk, dv), want))


def test_wrapper_rejects_bad_operands():
    _, (tq, tk, tv) = _qkv(1, 4, 2, 8, 8, 16, 16, 2, "float32")
    with pytest.raises(ValueError, match="dtype"):
        flash_attention_fwd(tq, tk.double(), tv)
    with pytest.raises(ValueError, match="multiple of kv heads"):
        flash_attention_fwd(tq[:, :3], tk, tv)
    with pytest.raises(ValueError, match="no kernel for device"):
        flash_attention_fwd(tq.to("meta"), tk.to("meta"), tv.to("meta"))
    out, lse = flash_attention_fwd(tq, tk, tv)
    with pytest.raises(ValueError, match="out and dout"):
        flash_attention_bwd(tq, tk, tv, out, lse, out[:, :, :4])
    with pytest.raises(ValueError, match="lse must be"):
        flash_attention_bwd(tq, tk, tv, out, lse.double(), out)
    with pytest.raises(ValueError, match="dout must be"):
        flash_attention_bwd_dq(tq, tk, tv, out[..., :8], lse, lse)
    meta = lambda *ts: [t.to("meta") for t in ts]
    with pytest.raises(ValueError, match="no kernel for device"):
        flash_attention_bwd_dkv(*meta(tq, tk, tv, out, lse, lse))


def _bwd_inputs(case, seed):
    b, h, kv, l, s, dk, dv = case[:7]
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(size=shape).astype(np.float32) for shape in
              ((b, h, l, dk), (b, kv, s, dk), (b, kv, s, dv), (b, h, l, dv))]
    return [jnp.asarray(a) for a in arrays], [torch.tensor(a) for a in arrays]


def _port_grads(tq, tk, tv, dout, causal):
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    out, _ = flash_attention(*leaves, causal)
    return torch.autograd.grad(out, leaves, dout)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("causal", [True, False])
def test_bwd_matches_pallas_interpret(case, causal):
    """dQ, dK, dV through the port's autograd against repro's ``_flash_bwd``
    on repro's own (out, lse), fp32, at 2e-4."""
    b, h, kv, l, s, dk, dv, bq, bk = case
    if causal and l != s:
        pytest.skip("causal assumes L == S here")
    (q, k, v, do), (tq, tk, tv, tdo) = _bwd_inputs(case, sum(case) + 3)
    scale = dk**-0.5
    out, lse = _flash_fwd(q, k, v, causal=causal, sm_scale=scale, block_q=bq, block_k=bk,
                          interpret=True)
    want = _flash_bwd((q, k, v, out, lse), do, causal=causal, sm_scale=scale, block_q=bq,
                      block_k=bk, interpret=True)
    for name, got, w in zip(("dq", "dk", "dv"), _port_grads(tq, tk, tv, tdo, causal), want):
        assert got.shape == w.shape, name
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=2e-4, atol=2e-4,
                                   err_msg=name)


@pytest.mark.parametrize("l,block", [(40, 16), (1088, 512)])
def test_bwd_tail_lengths_match_ref_attention_grad(l, block):
    """L = S not a multiple of the block: the port's gradients equal
    ``jax.grad`` of ``ref_attention`` (2e-4), causal and not, where repro's
    ``_flash_bwd`` gives NaN (probed at L = 40: ROADMAP Queue 3)."""
    case = (1, 4, 2, l, l, 16, 16)
    (q, k, v, do), (tq, tk, tv, tdo) = _bwd_inputs(case, l)
    for causal in (True, False):
        want = jax.grad(lambda a, b_, c: jnp.sum(ref_attention(a, b_, c, causal=causal) * do),
                        argnums=(0, 1, 2))(q, k, v)
        got = _port_grads(tq, tk, tv, tdo, causal)
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            assert bool(torch.isfinite(g).all()), name
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4, atol=2e-4,
                                       err_msg=f"{name} causal={causal}")
    if l == 40:
        out, lse = _flash_fwd(q, k, v, causal=True, sm_scale=0.25, block_q=block, block_k=block,
                              interpret=True)
        bad = _flash_bwd((q, k, v, out, lse), do, causal=True, sm_scale=0.25, block_q=block,
                         block_k=block, interpret=True)
        assert all(bool(np.isnan(np.asarray(g)).any()) for g in bad)


def test_flash_model_grads_do_not_depend_on_blocks():
    """The smoke model's loss gradients through flash attention at L = 40
    are the same bit for bit under any ``flash_block_q`` / ``flash_block_k``
    and equal repro's naive path (fp32, 1e-4)."""
    rcfg = dataclasses.replace(r_smoke_config("llama3.2-1b"), dtype="float32")
    params = rtfm.init_params(jax.random.key(1), rcfg)
    tokens = np.random.default_rng(4).integers(0, rcfg.vocab, (2, 40)).astype(np.int32)
    want = jax.grad(rtfm.make_loss_fn(rcfg))(params, {"tokens": jnp.asarray(tokens)})
    grads = []
    for block in (16, 64, 512):
        cfg = dataclasses.replace(get_smoke_config("llama3.2-1b"), dtype="float32",
                                  attn_impl="flash", flash_block_q=block, flash_block_k=block)
        model = model_params_from_numpy(cfg, jax.tree.map(np.asarray, params), "cpu")
        loss = tfm.make_loss_fn(cfg)(model, {"tokens": torch.as_tensor(tokens)})
        grads.append(torch.autograd.grad(loss, [model.layers[0].attn.wq, model.embed.tok]))
    assert all(torch.equal(a, b) for g in grads[1:] for a, b in zip(grads[0], g))
    np.testing.assert_allclose(grads[0][0].numpy(), np.asarray(want["layers"]["attn"]["wq"][0]),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(grads[0][1].numpy(), np.asarray(want["embed"]["tok"]),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_backward_gradcheck(causal):
    """The plain forward + backward in float64 at a tiny GQA shape, dk != dv,
    L != S: the backward's formulas against finite differences."""
    gen = torch.Generator().manual_seed(2)
    leaves = [torch.randn(s, dtype=torch.float64, generator=gen, requires_grad=True)
              for s in ((1, 4, 5, 8), (1, 2, 7, 8), (1, 2, 7, 4))]
    assert torch.autograd.gradcheck(lambda a, b_, c: flash_attention(a, b_, c, causal)[0],
                                    leaves)


def _tc_emulation(q, k, v, out, lse, dout, causal: bool, scale: float, split: bool):
    """The bf16 tensor-core backward's arithmetic in plain PyTorch: bf16
    operands, fp32 sums; P and dS enter dS K, P^T dO and dS^T Q as bf16
    operands, either split (hi = bf16(x), lo = bf16(x - hi), two products
    summed in fp32) or rounded once. Each output is rounded to bf16 once."""
    b, h, l, _ = q.shape
    kvh, s = k.shape[1], k.shape[2]
    g = h // kvh
    grouped = lambda t: t.float().reshape(b, kvh, g, l, t.shape[-1])
    qg, dog, kf, vf = grouped(q), grouped(dout), k.float(), v.float()
    p = torch.exp(torch.einsum("bkgld,bksd->bkgls", qg, kf) * scale
                  - lse.reshape(b, kvh, g, l, 1))
    if causal:
        p = torch.where(torch.arange(l)[:, None] >= torch.arange(s), p, torch.zeros(()))
    dp = torch.einsum("bkgld,bksd->bkgls", dog, vf)
    delta = (dout.float() * out.float()).sum(-1).reshape(b, kvh, g, l, 1)
    ds = p * (dp - delta) * scale

    def operand(x):
        hi = x.to(torch.bfloat16).float()
        return (hi, (x - hi).to(torch.bfloat16).float()) if split else (hi,)

    dq = sum(torch.einsum("bkgls,bksd->bkgld", a, kf) for a in operand(ds))
    dk = sum(torch.einsum("bkgls,bkgld->bksd", a, qg) for a in operand(ds))
    dv = sum(torch.einsum("bkgls,bkgld->bksd", a, dog) for a in operand(p))
    return tuple(t.to(torch.bfloat16) for t in (dq.reshape(q.shape), dk, dv))


@pytest.mark.parametrize("case", [
    # (B, H, KV, L, S, dk, dv, causal)
    (2, 8, 2, 333, 333, 64, 64, True),  # tails, g = 4
    (2, 4, 2, 130, 130, 48, 32, True),  # dk != dv
    (1, 4, 4, 100, 300, 32, 32, False),  # non-causal, S > L
    (1, 4, 1, 1024, 1024, 64, 64, True),  # g = 4 over long causal rows
])
def test_tensor_core_numerics_hold_bf16_limit(case):
    """The bf16 tensor-core kernels' numerics, emulated on the CPU, against
    the fp32 plain version under chip_smoke.py's bf16 limit |g - w| <= 2e-4
    + 2^-7 |w| (GRAD_TOL): with P and dS split hi/lo the reading stays at
    most 1. The same emulation with P and dS rounded once to bf16 is printed
    beside it, not asserted: it shows what the split buys."""
    b, h, kv, l, s, dk, dv, causal = case
    rng = np.random.default_rng(sum(case[:7]))
    make = lambda *shape: torch.tensor(rng.normal(size=shape).astype(np.float32)).to(
        torch.bfloat16)
    q, k, v, dout = make(b, h, l, dk), make(b, kv, s, dk), make(b, kv, s, dv), make(b, h, l, dv)
    scale = dk**-0.5
    out, lse = flash_attention_plain(q, k, v, causal, scale)
    want = flash_attention_bwd_plain(q, k, v, out, lse, dout, causal, scale)
    readings = {}
    for split in (True, False):
        got = _tc_emulation(q, k, v, out, lse, dout, causal, scale, split)
        readings[split] = {name: float(((g.float() - w.float()).abs()
                                        / (2e-4 + 2.0**-7 * w.float().abs())).max())
                           for name, g, w in zip(("dq", "dk", "dv"), got, want)}
    print(f"{case}: reading of the bf16 limit, P and dS split hi/lo {readings[True]}; "
          f"rounded once {readings[False]}")
    assert max(readings[True].values()) <= 1, readings[True]


def _tc_fwd_emulation(q, k, v, causal: bool, scale: float, split: bool):
    """The bf16 tensor-core forward's arithmetic in plain PyTorch: S = Q K^T
    of bf16 values summed in fp32; the online softmax in fp32 over key tiles
    of the kernel's width (128 keys at d <= 64, else 64); P enters P V as
    bf16 operands, split (hi = bf16(P), lo = bf16(P - hi), two products
    summed in fp32) or rounded once; O = acc / l rounded to bf16 once, LSE =
    m + log l in fp32."""
    b, h, l, dk = q.shape
    kvh, s, dv = k.shape[1], k.shape[2], v.shape[3]
    g = h // kvh
    bn = 128 if max(dk, dv) <= 64 else 64
    qg, kf, vf = q.float().reshape(b, kvh, g, l, dk), k.float(), v.float()
    m = torch.full((b, kvh, g, l, 1), NEG_INF)
    lsum = torch.zeros((b, kvh, g, l, 1))
    acc = torch.zeros((b, kvh, g, l, dv))
    rows = torch.arange(l)[:, None]
    for s0 in range(0, s, bn):
        sc = torch.einsum("bkgld,bksd->bkgls", qg, kf[:, :, s0:s0 + bn])
        if causal:
            sc = torch.where(rows >= torch.arange(s0, min(s0 + bn, s)), sc, torch.full((), NEG_INF))
        mx = torch.maximum(m, sc.amax(-1, keepdim=True))
        alpha, p = torch.exp((m - mx) * scale), torch.exp((sc - mx) * scale)
        lsum, acc, m = lsum * alpha + p.sum(-1, keepdim=True), acc * alpha, mx
        hi = p.to(torch.bfloat16).float()
        for a in ((hi, (p - hi).to(torch.bfloat16).float()) if split else (hi,)):
            acc = acc + torch.einsum("bkgls,bksd->bkgld", a, vf[:, :, s0:s0 + bn])
    lf = lsum.clamp_min(1e-30)
    out = (acc / lf).to(torch.bfloat16).reshape(b, h, l, dv)
    return out, (m * scale + torch.log(lf)).reshape(b, h, l)


def _bf16_reading(got, want) -> float:
    """max |got - want| / (tol + tol |want|) at FLASH_TOL's bf16 limit."""
    tol = TOL["bfloat16"]
    got, want = got.float(), want.float()
    return float(((got - want).abs() / (tol + tol * want.abs())).max())


@pytest.mark.parametrize("case", [
    # (B, H, KV, L, S, dk, dv, causal, reference): L and S multiples of the
    # Pallas block where repro's _flash_fwd is the reference, tails where
    # the port's plain version is
    (1, 8, 2, 256, 256, 64, 64, True, "pallas"),  # g = 4, two 128-key tiles
    (1, 2, 2, 128, 128, 128, 128, True, "pallas"),  # class 128: 64-key tiles
    (1, 4, 4, 128, 256, 32, 32, False, "pallas"),  # non-causal, S > L
    (2, 8, 2, 333, 333, 64, 64, True, "plain"),  # tails, g = 4
    (2, 4, 2, 130, 130, 48, 32, True, "plain"),  # dk != dv
    (1, 4, 4, 100, 300, 32, 32, False, "plain"),  # non-causal, S > L, tails
    (1, 2, 1, 150, 150, 256, 256, True, "plain"),  # class 256
])
def test_tensor_core_forward_numerics_hold_bf16_limit(case):
    """The bf16 tensor-core forward's numerics, emulated on the CPU, against
    repro's ``_flash_fwd`` in interpret mode (bf16 in, where its blocks
    divide L and S) or the port's plain version (tails, where repro gives
    NaN), both outputs in bf16: with P split hi/lo the reading of
    chip_smoke.py's bf16 limit FLASH_TOL (2e-2 + 2e-2 |w|) is at most 1.
    The same emulation with P rounded once to bf16 is printed beside it."""
    b, h, kv, l, s, dk, dv, causal, reference = case
    (q, k, v), (tq, tk, tv) = _qkv(b, h, kv, l, s, dk, dv, sum(case[:7]), "bfloat16")
    scale = dk**-0.5
    if reference == "pallas":
        block = min(l, s, 128)
        want = _flash_fwd(q, k, v, causal=causal, sm_scale=scale, block_q=block, block_k=block,
                          interpret=True)
        want_out, want_lse = (torch.tensor(np.asarray(w, np.float32)) for w in want)
    else:
        want_out, want_lse = flash_attention_plain(tq, tk, tv, causal, scale)
    readings = {}
    for split in (True, False):
        out, lse = _tc_fwd_emulation(tq, tk, tv, causal, scale, split)
        assert out.dtype == torch.bfloat16 and out.shape == (b, h, l, dv)
        readings[split] = (_bf16_reading(out, want_out), _bf16_reading(lse, want_lse))
    print(f"{case}: reading of the bf16 limit (out, lse), P split hi/lo {readings[True]}; "
          f"P rounded once {readings[False]}")
    assert max(readings[True]) <= 1, readings[True]


def test_tma_ready_copies_only_unaligned():
    """The bf16 forward's operands as TMA reads them: the model's (B, L, H,
    d) views of d = 64 pass as they are; rows of 40 bytes (d = 20) and a
    view starting 2 bytes into its storage are copied into zero-padded
    memory whose strides are multiples of 16 bytes, with the same values."""
    from repro_torch.kernels.flash_attention import _tma_ready

    bf = torch.bfloat16
    wide = torch.randn(2, 70, 8, 64).to(bf).transpose(1, 2)
    narrow = torch.randn(2, 70, 8, 20).to(bf).transpose(1, 2)
    shifted = torch.zeros(2 * 8 * 70 * 64 + 1, dtype=bf)[1:].view(2, 8, 70, 64)
    assert _tma_ready(wide) is wide
    for t in (narrow, shifted):
        got = _tma_ready(t)
        assert got is not t and torch.equal(got, t)
        assert got.data_ptr() % 16 == 0 and all(st * 2 % 16 == 0 for st in got.stride()[:-1])
    assert _tma_ready(narrow).stride()[-2] == 24


def test_bf16_row_copy_width():
    """The bytes per row copy the bf16 backward kernels are given: 16 for
    rows of 64 bf16 in the model's layout, 8 for rows of 20 (40 bytes), 4
    for a view starting 2 elements into its storage; a tensor whose rows are
    not 4-byte aligned (odd row stride) is copied to fresh memory first."""
    from repro_torch.kernels.flash_attention import _aligned_rows, _row_bytes

    bf = torch.bfloat16
    wide = torch.zeros(2, 70, 8, 64, dtype=bf).transpose(1, 2)
    narrow = torch.zeros(2, 70, 8, 20, dtype=bf).transpose(1, 2)
    shifted = torch.zeros(2 * 8 * 70 * 64 + 2, dtype=bf)[2:].view(2, 8, 70, 64)
    odd = torch.zeros(2, 8, 70, 65, dtype=bf)[..., :64]  # row stride 65 elements
    assert [_row_bytes(t) for t in (wide, narrow, shifted, odd)] == [16, 8, 4, 2]
    got = _aligned_rows(wide, wide, wide, shifted)
    assert got[4] == 4 and all(a is b for a, b in zip(got[:4], (wide, wide, wide, shifted)))
    got = _aligned_rows(wide, wide, wide, odd)
    assert got[4] == 16 and got[3] is not odd and torch.equal(got[3], odd)
    assert got[3].is_contiguous()
