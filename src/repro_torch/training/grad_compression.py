"""int8 gradient compression with error feedback for the data-parallel
mean (``repro/training/grad_compression.py``).

``quantize_int8`` / ``dequantize_int8`` are ``repro``'s per-tensor absmax
grid. ``compressed_psum_mean`` is ``repro``'s error-feedback mean over the
data-parallel ranks, in SPMD: every rank of ``mesh`` calls it with its own
gradients (blocks of the logical leaves where the model axis splits them)
and its own residual. Per leaf it quantizes the gradient plus the residual
to int8 on the grid of the whole logical leaf's absmax: the max reduced
over the model axis where the leaf is split, as ``repro``'s TP-automatic
body sees the whole leaf, and a leaf is ``repro``'s, which stacks a stack's
layers, so one scale serves a parameter in every layer of its stack. It
sums the int payload over the data-parallel axes in int32 (exact: an int8
sum would overflow) and the float32 scales beside it, and returns ``mean =
q_sum * (scale_sum / n) / n``, ``repro``'s mean scale against the summed
payload, with the new residual, the rank's own quantization error. All
leaves travel in one int32 all-reduce and one float32 all-reduce.
"""

from __future__ import annotations

import re

import torch
import torch.distributed as dist


def quantize_int8(g: torch.Tensor, absmax: torch.Tensor = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor absmax int8 quantization. Returns (q int8, scale float32);
    ``absmax`` (default ``max |g|``) is that of the logical tensor."""
    gf = g.float()
    amax = torch.max(torch.abs(gf)) if absmax is None else absmax
    scale = amax / 127.0 + 1e-12
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def stacked_leaf(name: str) -> str:
    """``repro``'s leaf of a port parameter: its name without the layer
    indices (``layers.3.attn.wq`` -> ``layers.attn.wq``), since ``repro``
    stacks a stack's layers into one leaf."""
    return re.sub(r"\.\d+(?=\.)", "", name)


def compressed_payload(grads: dict, axis_names, residual: dict = None, mesh=None,
                       specs: dict = None):
    """What travels, summed: (q_sum int32, the payload of every gradient
    flattened in ``grads``' order; {name: the summed scale of its leaf};
    the new residual; n, the ranks summed over). See
    ``compressed_psum_mean``."""
    from repro_torch.launch.mesh import axis_group
    from repro_torch.launch.sharding import all_reduce, spec_axes

    if mesh is None:
        raise ValueError("compressed_psum_mean sums over the data-parallel ranks of a device "
                         "mesh: pass the mesh (repro's runs inside shard_map)")
    ag = axis_group(mesh, tuple(axis_names))
    model = axis_group(mesh, ("model",))
    names = list(grads)
    leaf = {k: stacked_leaf(k) for k in names}
    leaves = list(dict.fromkeys(leaf.values()))
    g_in = {k: grads[k].float() + (residual[k] if residual is not None else 0.0) for k in names}
    amax = torch.stack([torch.max(torch.stack([torch.max(torch.abs(g_in[k]))
                                               for k in names if leaf[k] == lf]))
                        for lf in leaves])
    split = torch.tensor([specs is not None and any(
        "model" in spec_axes(e) for k in names if leaf[k] == lf for e in specs[k])
        for lf in leaves], device=amax.device)
    if model is not None and bool(split.any()):
        whole = all_reduce(amax, model, mesh, dist.ReduceOp.MAX)
        amax = torch.where(split, whole, amax)
    scales = amax / 127.0 + 1e-12  # quantize_int8's, of each logical leaf
    at = {lf: i for i, lf in enumerate(leaves)}
    qs, new_res = [], {}
    for k in names:
        q, scale = quantize_int8(g_in[k], amax[at[leaf[k]]])
        new_res[k] = g_in[k] - dequantize_int8(q, scale)  # stays local
        qs.append(q.reshape(-1).to(torch.int32))
    q_sum = all_reduce(torch.cat(qs), ag, mesh)
    scale_sum = all_reduce(scales, ag, mesh)
    return (q_sum, {k: scale_sum[at[leaf[k]]] for k in names}, new_res,
            1 if ag is None else ag.size)


def compressed_psum_mean(grads: dict, axis_names, residual: dict = None, mesh=None,
                         specs: dict = None):
    """Quantize -> sum (int32) over the mesh axes ``axis_names`` ->
    dequantize with the mean scale; error feedback. ``grads`` {name:
    tensor}; ``residual`` the same keys in float32 (zeros when None);
    ``specs`` {name: spec} names the gradients the model axis splits (None:
    none is split). Returns (mean grads in each gradient's dtype, new
    residual). Needs a mesh: ``repro``'s runs inside shard_map."""
    q_sum, scale_sum, new_res, n = compressed_payload(grads, axis_names, residual, mesh, specs)
    out, at = {}, 0
    for k, g in grads.items():
        mean = q_sum[at:at + g.numel()].float() * (scale_sum[k] / n) / n
        out[k] = mean.reshape(g.shape).to(g.dtype)
        at += g.numel()
    return out, new_res
