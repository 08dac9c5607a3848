"""Flash-attention forward: kernel wrapper + plain version.

Replaces the forward of ``repro/kernels/flash_attention.py`` (``_flash_fwd``,
body ``_fwd_kernel``). The CUDA kernel is ``csrc/flash_attention.cu``: one
block per (batch, head, 64 query rows) streams 64-row K/V tiles through
shared memory with the online-softmax recurrence in fp32, so the (L, S)
score matrix never reaches device memory. GQA maps query head h to kv head
h // (H / KV); dk != dv is allowed. Bound on the H100: operations at the RAG
prefill shape (~430 flop per byte).

It computes what the Pallas kernel is meant to compute, with two
differences of record (ROADMAP Queue 3): key columns >= S and query rows
>= L of a partial tile are masked, so the result does not depend on the
tile size (the Pallas kernel gives NaN when L or S is larger than its block
and not a multiple of it); and ``flash_attention_plain`` carries the
kernel's causal mask ``row >= col`` (aligned top-left), not
``ref_attention``'s bottom-right ``tril(k = S - L)``. The two agree when
L == S, the only case the models use.

``flash_attention_fwd`` launches the kernel for CUDA tensors (or raises) and
takes the plain version for CPU tensors. ``flash_attention`` is the public
call, a ``torch.autograd.Function`` whose backward is not ported yet.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.hybrid_distance import _need

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_plain(q, k, v, causal: bool, sm_scale: float):
    """Plain version (``ref_attention`` with the kernel's top-left causal
    mask). q: (B, H, L, dk); k: (B, KV, S, dk); v: (B, KV, S, dv) ->
    (out (B, H, L, dv) in q.dtype, lse (B, H, L) float32)."""
    b, h, l, dk = q.shape
    kvh, s = k.shape[1], k.shape[2]
    g = h // kvh
    qg = q.reshape(b, kvh, g, l, dk).float()
    scores = torch.einsum("bkgld,bksd->bkgls", qg, k.float()) * sm_scale
    if causal:
        rows = torch.arange(l, device=q.device)[:, None]
        cols = torch.arange(s, device=q.device)[None, :]
        scores = torch.where(rows >= cols, scores, torch.full_like(scores, NEG_INF))
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgls,bksd->bkgld", w, v.float())
    lse = torch.logsumexp(scores, dim=-1)
    return out.reshape(b, h, l, v.shape[-1]).to(q.dtype), lse.reshape(b, h, l)


def _check(q, k, v) -> None:
    _need(q.device == k.device == v.device, "q, k, v lie on several devices")
    _need(q.dim() == 4 and k.dim() == 4 and v.dim() == 4, "q, k, v must be 4-D")
    _need(q.dtype == k.dtype == v.dtype and q.dtype in _DTYPES,
          f"q, k, v must share one dtype of {list(_DTYPES)}")
    b, h, _, dk = q.shape
    _need(k.shape[0] == b and v.shape[0] == b, "q, k, v batch sizes differ")
    _need(k.shape[1] == v.shape[1] and k.shape[2] == v.shape[2], "k and v shapes differ")
    _need(k.shape[3] == dk, "q and k head dims differ")
    _need(k.shape[1] >= 1 and h % k.shape[1] == 0, "query heads must be a multiple of kv heads")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _need(t.stride(-1) == 1, f"{name}: the head dim must be contiguous")


def flash_attention_fwd(q, k, v, causal: bool = True, sm_scale: float | None = None):
    """``(out, lse)`` as ``_flash_fwd`` returns them: out (B, H, L, dv) in
    q.dtype, lse (B, H, L) float32. CUDA tensors launch the kernel; CPU
    tensors take the plain version. On CUDA, ``out`` is a (B, H, L, dv) view
    of (B, L, H, dv) memory, the layout the model's output projection reads."""
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
    _need(lib.flash_attention_smem_bytes(dk, dv) <= _build.MAX_SMEM_BYTES,
          "flash attention: head dims exceed shared memory")
    _need(b <= 65535 and h <= 65535, "flash attention: batch or heads exceed the grid")
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


class _FlashAttention(torch.autograd.Function):
    """``repro``'s ``flash_attention`` custom_vjp: the forward kernel here,
    the backward kernels with the training slice."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        out, lse = flash_attention_fwd(q, k, v, causal, sm_scale)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        raise NotImplementedError(
            "flash attention backward (_bwd_dq_kernel, _bwd_dkv_kernel) is not ported "
            "yet: ROADMAP Queue 2")


def flash_attention(q, k, v, causal: bool = True, sm_scale: float | None = None):
    """q: (B, H, L, dk); k: (B, KV, S, dk); v: (B, KV, S, dv) ->
    (out (B, H, L, dv) in q.dtype, lse (B, H, L) float32). ``sm_scale``
    defaults to dk ** -0.5."""
    scale = q.shape[-1] ** -0.5 if sm_scale is None else float(sm_scale)
    return _FlashAttention.apply(q, k, v, causal, scale)
