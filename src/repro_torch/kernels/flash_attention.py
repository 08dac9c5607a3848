"""Flash attention, forward and backward: kernel wrappers + plain versions.

Replaces ``repro/kernels/flash_attention.py``: the forward (``_flash_fwd``,
body ``_fwd_kernel``) and the backward (``_flash_bwd``, bodies
``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``). Each has two CUDA routes,
picked by dtype at the C entry points: float32 on the CUDA cores
(``csrc/flash_attention.cu``, ``csrc/flash_attention_bwd.cu``), bfloat16 on
the tensor cores: the forward ``csrc/flash_attention_tc.cu`` (``wgmma`` fed
by TMA; persistent blocks, one per SM, over (batch, head, 128 query rows)),
the backward ``csrc/flash_attention_bwd_tc.cu`` (``mma.sync``). Both bf16
routes split P (and dS) hi/lo into two bf16 operands, so the products keep
fp32-grade P. The forward streams K/V tiles through shared memory with the
online-softmax recurrence in fp32, so the (L, S) score matrix never reaches
device memory. The backward recomputes P from the forward's LSE: one kernel
per (batch, head, 64 query rows) for dQ, one per (batch, kv head, 64 key
rows) for dK and dV, summed over the query heads of the group without
atomics. GQA maps query head h to kv head h // (H / KV); dk != dv is
allowed. Bound on the H100: operations.

They compute what the Pallas kernels are meant to compute, with two
differences of record (ROADMAP Queue 3), forward and backward alike: key
columns >= S and query rows >= L of a partial tile are masked, so the result
does not depend on the tile size (the Pallas kernels give NaN when L or S is
larger than their block and not a multiple of it); and the causal mask is
the kernels' ``row >= col`` (aligned top-left), not ``ref_attention``'s
bottom-right ``tril(k = S - L)``. The two agree when L == S, the only case
the models use.

``flash_attention_fwd`` and ``flash_attention_bwd`` launch the kernels for
CUDA tensors (or raise) and take the plain versions for CPU tensors.
``flash_attention`` is the public call, a ``torch.autograd.Function``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.hybrid_distance import _need

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _acc(t: torch.Tensor) -> torch.Tensor:
    """The plain versions' working precision: float32, or float64 for a
    float64 CPU tensor (gradcheck)."""
    return t.double() if t.dtype == torch.float64 else t.float()


def flash_attention_plain(q, k, v, causal: bool, sm_scale: float):
    """Plain version (``ref_attention`` with the kernel's top-left causal
    mask). q: (B, H, L, dk); k: (B, KV, S, dk); v: (B, KV, S, dv) ->
    (out (B, H, L, dv) in q.dtype, lse (B, H, L) float32)."""
    b, h, l, dk = q.shape
    kvh, s = k.shape[1], k.shape[2]
    g = h // kvh
    qg = _acc(q.reshape(b, kvh, g, l, dk))
    scores = torch.einsum("bkgld,bksd->bkgls", qg, _acc(k)) * sm_scale
    if causal:
        rows = torch.arange(l, device=q.device)[:, None]
        cols = torch.arange(s, device=q.device)[None, :]
        scores = torch.where(rows >= cols, scores, torch.full_like(scores, NEG_INF))
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgls,bksd->bkgld", w, _acc(v))
    lse = torch.logsumexp(scores, dim=-1)
    return out.reshape(b, h, l, v.shape[-1]).to(q.dtype), lse.reshape(b, h, l)


def _check(q, k, v) -> None:
    _need(q.device == k.device == v.device, "q, k, v lie on several devices")
    _need(q.dim() == 4 and k.dim() == 4 and v.dim() == 4, "q, k, v must be 4-D")
    # float64 only on the CPU, for gradcheck of the plain versions
    kinds = list(_DTYPES) + ([torch.float64] if q.device.type == "cpu" else [])
    _need(q.dtype == k.dtype == v.dtype and q.dtype in kinds,
          f"q, k, v must share one dtype of {kinds}")
    b, h, _, dk = q.shape
    _need(k.shape[0] == b and v.shape[0] == b, "q, k, v batch sizes differ")
    _need(k.shape[1] == v.shape[1] and k.shape[2] == v.shape[2], "k and v shapes differ")
    _need(k.shape[3] == dk, "q and k head dims differ")
    _need(k.shape[1] >= 1 and h % k.shape[1] == 0, "query heads must be a multiple of kv heads")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _need(t.stride(-1) == 1, f"{name}: the head dim must be contiguous")


def _tma_ready(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when TMA can read it (a 16-byte aligned start and every
    stride but the last a multiple of 16 bytes, as in the model's (B, L, H,
    d) memory for d a multiple of 8), else a copy in zero-padded contiguous
    memory (e.g. d = 20)."""
    esz = t.element_size()
    if t.data_ptr() % 16 == 0 and all(s * esz % 16 == 0 for s in t.stride()[:-1]):
        return t
    d = t.shape[-1]
    padded = torch.zeros((*t.shape[:-1], -(-d * esz // 16) * 16 // esz), dtype=t.dtype,
                         device=t.device)
    padded[..., :d] = t
    return padded[..., :d]


def flash_attention_fwd(q, k, v, causal: bool = True, sm_scale: float | None = None):
    """``(out, lse)`` as ``_flash_fwd`` returns them: out (B, H, L, dv) in
    q.dtype, lse (B, H, L) float32. CUDA tensors launch the kernel (bf16 the
    tensor-core one, fp32 the CUDA-core one); CPU tensors take the plain
    version. On CUDA, ``out`` is a (B, H, L, dv) view of (B, L, H, dv)
    memory, the layout the model's output projection reads."""
    scale = q.shape[-1] ** -0.5 if sm_scale is None else float(sm_scale)
    _check(q, k, v)
    dev = q.device
    if dev.type == "cpu":
        return flash_attention_plain(q, k, v, causal, scale)
    _need(dev.type == "cuda", f"no kernel for device {dev}")
    b, h, l, dk = q.shape
    kvh, s, dv = k.shape[1], k.shape[2], v.shape[3]
    out = torch.empty((b, l, h, dv), dtype=q.dtype, device=dev).transpose(1, 2)
    lse = torch.empty((b, h, l), dtype=torch.float32, device=dev)
    if b == 0 or h == 0 or l == 0:
        return out, lse
    _need(s >= 1, "flash attention needs S >= 1")
    lib = _build.library()
    max_d = lib.flash_attention_max_d()
    _need(dk % 4 == 0 and dv % 4 == 0 and dk <= max_d and dv <= max_d,
          f"flash attention takes dk, dv multiples of 4 up to {max_d}, got {dk}, {dv}")
    _need(lib.flash_attention_smem_bytes(dk, dv, _DTYPES[q.dtype]) <= _build.MAX_SMEM_BYTES,
          "flash attention: head dims exceed shared memory")
    _need(b <= 65535 and h <= 65535, "flash attention: batch or heads exceed the grid")
    if q.dtype == torch.bfloat16:  # held until the launch is enqueued
        q, k, v = (_tma_ready(t) for t in (q, k, v))
    rc = lib.flash_attention_fwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        b, h, kvh, l, s, dk, dv,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        int(causal), scale, _DTYPES[q.dtype], *_build.device_and_stream(out),
    )
    flash_attention_fwd.launches += 1
    _build.check(rc, "flash_attention_fwd")
    return out, lse


flash_attention_fwd.launches = 0


def _bwd_plain(q, k, v, dout, lse, delta, causal: bool, sm_scale: float):
    """(dq, dk, dv) with P recomputed from ``lse`` and dS = P o (dO V^T -
    Delta) scale, all in float32, cast to q's, k's and v's dtypes; dk and dv
    summed over the query heads of each kv head."""
    b, h, l, dk = q.shape
    kvh, s = k.shape[1], k.shape[2]
    g = h // kvh
    grouped = lambda t: _acc(t.reshape(b, kvh, g, l, t.shape[-1]))
    qg, dog = grouped(q), grouped(dout)
    kf, vf = _acc(k), _acc(v)
    scores = torch.einsum("bkgld,bksd->bkgls", qg, kf) * sm_scale
    p = torch.exp(scores - lse.reshape(b, kvh, g, l, 1))
    if causal:
        keep = torch.arange(l, device=q.device)[:, None] >= torch.arange(s, device=q.device)
        p = torch.where(keep, p, torch.zeros((), device=q.device))
    dp = torch.einsum("bkgld,bksd->bkgls", dog, vf)
    ds = p * (dp - delta.reshape(b, kvh, g, l, 1)) * sm_scale
    dq = torch.einsum("bkgls,bksd->bkgld", ds, kf).reshape(b, h, l, dk)
    dkk = torch.einsum("bkgls,bkgld->bksd", ds, qg)
    dv = torch.einsum("bkgls,bkgld->bksd", p, dog)
    return dq.to(q.dtype), dkk.to(k.dtype), dv.to(v.dtype)


def _delta(out, dout):
    """Delta = rowsum(dO o O) in float32, (B, H, L), taken outside the
    kernels as ``_flash_bwd`` takes it."""
    return (_acc(dout) * _acc(out)).sum(-1)


def flash_attention_bwd_plain(q, k, v, out, lse, dout, causal: bool, sm_scale: float):
    """Plain version of the backward, as ``_flash_bwd`` computes it. q: (B,
    H, L, dk); k: (B, KV, S, dk); v: (B, KV, S, dv); out and dout (B, H, L,
    dv); lse (B, H, L) float32 -> (dq, dk, dv) in q's, k's and v's dtypes."""
    return _bwd_plain(q, k, v, dout, lse, _delta(out, dout), causal, sm_scale)


def _bwd_operands(q, k, v, dout, lse, delta):
    """Checks the backward's operands; returns ``dout`` in q's dtype with a
    contiguous last dimension (autograd may hand over any strides)."""
    _check(q, k, v)
    b, h, l, _ = q.shape
    dv = v.shape[3]
    _need(tuple(dout.shape) == (b, h, l, dv), "dout must be (B, H, L, dv)")
    for name, t in (("lse", lse), ("delta", delta)):
        _need(tuple(t.shape) == (b, h, l) and t.dtype == _acc(q[:0]).dtype,
              f"{name} must be (B, H, L) float32")
    _need(dout.device == lse.device == delta.device == q.device,
          "operands lie on several devices")
    if dout.dtype != q.dtype or dout.stride(-1) != 1:
        dout = dout.to(q.dtype).contiguous()
    return dout


def _grad_like(b, heads, n, d, dtype, dev):
    """A (B, heads, n, d) view of (B, n, heads, d) memory: the layout of the
    model's projections, so the transposes that follow are free."""
    return torch.empty((b, n, heads, d), dtype=dtype, device=dev).transpose(1, 2)


def _bwd_library(q, k, v):
    """The kernel library, after the checks both backward kernels share."""
    b, h, _, dk = q.shape
    dv = v.shape[3]
    lib = _build.library()
    max_d = lib.flash_attention_max_d()
    _need(dk % 4 == 0 and dv % 4 == 0 and dk <= max_d and dv <= max_d,
          f"flash attention takes dk, dv multiples of 4 up to {max_d}, got {dk}, {dv}")
    _need(lib.flash_attention_bwd_smem_bytes(dk, dv, _DTYPES[q.dtype]) <= _build.MAX_SMEM_BYTES,
          "flash attention backward: head dims exceed shared memory")
    _need(b <= 65535 and h <= 65535, "flash attention: batch or heads exceed the grid")
    return lib


def _row_bytes(t: torch.Tensor) -> int:
    """The widest copy (16, 8, 4, 2 or 1 bytes) that divides the start and
    the length of every row of ``t`` and the step between them."""
    width = 16
    for x in (t.data_ptr(), t.shape[-1] * t.element_size(),
              *(s * t.element_size() for s in t.stride()[:-1])):
        while x % width:
            width //= 2
    return width


def _aligned_rows(q, k, v, dout):
    """(q, k, v, dout, vec): ``vec`` is the bytes per copy the bf16 kernels
    use for rows (16, or 8 or 4 where a row start is not 16-byte aligned,
    e.g. d = 20); a tensor whose rows are not even 4-byte aligned is copied
    to fresh memory first."""
    ts = [t if _row_bytes(t) >= 4 else t.clone(memory_format=torch.contiguous_format)
          for t in (q, k, v, dout)]
    return (*ts, min(_row_bytes(t) for t in ts))


def _bwd_args(q, k, v, dout):
    b, h, l, dk = q.shape
    return (b, h, k.shape[1], l, k.shape[2], dk, v.shape[3], *q.stride()[:3],
            *k.stride()[:3], *v.stride()[:3], *dout.stride()[:3])


def flash_attention_bwd_dq(q, k, v, dout, lse, delta, causal: bool = True,
                           sm_scale: float | None = None):
    """dQ (B, H, L, dk) in q.dtype, as ``_bwd_dq_kernel`` computes it, from
    the forward's ``lse`` and ``delta`` = rowsum(dO o O). CUDA tensors launch
    the kernel; CPU tensors take the plain version. On CUDA, dQ is a view of
    (B, L, H, dk) memory."""
    scale = q.shape[-1] ** -0.5 if sm_scale is None else float(sm_scale)
    dout = _bwd_operands(q, k, v, dout, lse, delta)
    dev = q.device
    if dev.type == "cpu":
        return _bwd_plain(q, k, v, dout, lse, delta, causal, scale)[0]
    _need(dev.type == "cuda", f"no kernel for device {dev}")
    b, h, l, dk = q.shape
    dq = _grad_like(b, h, l, dk, q.dtype, dev)
    if dq.numel() == 0 or k.shape[2] == 0:
        return dq.zero_()
    lib = _bwd_library(q, k, v)
    # held until the launch is enqueued: a freed temporary's memory could be
    # handed to the next allocation before the kernel reads it
    lse, delta = lse.contiguous(), delta.contiguous()
    q, k, v, dout, vec = _aligned_rows(q, k, v, dout)
    rc = lib.flash_attention_bwd_dq_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), *_bwd_args(q, k, v, dout),
        *dq.stride()[:3], int(causal), scale, _DTYPES[q.dtype], vec,
        *_build.device_and_stream(dq))
    flash_attention_bwd_dq.launches += 1
    _build.check(rc, "flash_attention_bwd_dq")
    return dq


flash_attention_bwd_dq.launches = 0


def flash_attention_bwd_dkv(q, k, v, dout, lse, delta, causal: bool = True,
                            sm_scale: float | None = None):
    """(dK (B, KV, S, dk), dV (B, KV, S, dv)) in k's and v's dtypes, as
    ``_bwd_dkv_kernel`` computes them: summed over the query heads of each kv
    head. CUDA tensors launch the kernel; CPU tensors take the plain version.
    On CUDA, both are views of (B, S, KV, d) memory."""
    scale = q.shape[-1] ** -0.5 if sm_scale is None else float(sm_scale)
    dout = _bwd_operands(q, k, v, dout, lse, delta)
    dev = q.device
    if dev.type == "cpu":
        return _bwd_plain(q, k, v, dout, lse, delta, causal, scale)[1:]
    _need(dev.type == "cuda", f"no kernel for device {dev}")
    b, kvh, s, dk = k.shape
    dkk = _grad_like(b, kvh, s, dk, k.dtype, dev)
    dvv = _grad_like(b, kvh, s, v.shape[3], v.dtype, dev)
    if dkk.numel() == 0 and dvv.numel() == 0:
        return dkk, dvv
    if q.shape[2] == 0:
        return dkk.zero_(), dvv.zero_()
    lib = _bwd_library(q, k, v)
    lse, delta = lse.contiguous(), delta.contiguous()
    q, k, v, dout, vec = _aligned_rows(q, k, v, dout)
    rc = lib.flash_attention_bwd_dkv_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dkk.data_ptr(), dvv.data_ptr(),
        *_bwd_args(q, k, v, dout), *dkk.stride()[:3], *dvv.stride()[:3], int(causal), scale,
        _DTYPES[q.dtype], vec, *_build.device_and_stream(dkk))
    flash_attention_bwd_dkv.launches += 1
    _build.check(rc, "flash_attention_bwd_dkv")
    return dkk, dvv


flash_attention_bwd_dkv.launches = 0


def flash_attention_bwd(q, k, v, out, lse, dout, causal: bool = True,
                        sm_scale: float | None = None):
    """``(dq, dk, dv)`` as ``_flash_bwd`` returns them, for the ``(out, lse)``
    that ``flash_attention_fwd`` gave: Delta = rowsum(dO o O) in float32,
    then the dQ kernel and the dK/dV kernel (CUDA), or the plain version
    (CPU). ``dout`` may have any strides."""
    scale = q.shape[-1] ** -0.5 if sm_scale is None else float(sm_scale)
    _need(tuple(out.shape) == tuple(dout.shape), "out and dout shapes differ")
    delta = _delta(out, dout)
    if q.device.type == "cpu":
        dout = _bwd_operands(q, k, v, dout, lse, delta)
        return _bwd_plain(q, k, v, dout, lse, delta, causal, scale)
    dq = flash_attention_bwd_dq(q, k, v, dout, lse, delta, causal, scale)
    dk, dv = flash_attention_bwd_dkv(q, k, v, dout, lse, delta, causal, scale)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """``repro``'s ``flash_attention`` custom_vjp: the forward kernel, and the
    two backward kernels on the saved (q, k, v, out, lse). The gradient of
    ``lse`` is ignored: it is not differentiable."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        out, lse = flash_attention_fwd(q, k, v, causal, sm_scale)
        ctx.mark_non_differentiable(lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, ctx.causal, ctx.sm_scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = True, sm_scale: float | None = None):
    """q: (B, H, L, dk); k: (B, KV, S, dk); v: (B, KV, S, dv) ->
    (out (B, H, L, dv) in q.dtype, lse (B, H, L) float32). ``sm_scale``
    defaults to dk ** -0.5."""
    scale = q.shape[-1] ** -0.5 if sm_scale is None else float(sm_scale)
    return _FlashAttention.apply(q, k, v, causal, scale)
