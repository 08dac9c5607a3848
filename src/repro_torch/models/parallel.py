"""The model side of a mesh step: which parameters a module computes on in
blocks, and the collectives it runs there (what GSPMD inserts in ``repro``).

A mesh step runs the model functions inside ``on_mesh``, with the model's
parameters swapped for the tensors it computes on: each rank's block where
the module is tensor-parallel over the model axis (its class names those
keys in ``tp_keys``), the rest gathered whole (``training.train_loop``).
There:

  * ``tp_group(p, key)`` is the model-axis group when parameter ``key`` of
    module ``p`` is split over ``"model"`` and ``p`` computes on its block,
    else None. The module then takes a replicated input through
    ``copy_to`` and makes its partial result replicated through
    ``reduce_from`` (Megatron's f and g).
  * ``dp_group()`` is the group of the data-parallel axes when the forward
    is the global program over them (gspmd mode: the MoE's capacity, slot
    order and aux loss are the whole batch's), None in the compressed mode,
    where each data-parallel rank runs the one-device program on its block.

Serving on a mesh (``serving.engine.ServingEngine(mesh=)``) runs prefill
and decode inside ``on_mesh`` too, with ``cache_specs``: the decode cache's
spec tree (``models.transformer.cache_specs``), by which each rank holds
and updates its block of every cache leaf (``cache_specs()`` reads it).

Outside ``on_mesh`` both are None and every model function runs on one
device as before. The state is a module global, not thread-local: the
backward's recomputation (remat) runs on autograd's threads.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch

MODEL = "model"


@dataclasses.dataclass
class _Active:
    mesh: object
    specs: dict  # parameter name -> spec
    names: dict  # id(module) -> its parameter-name prefix
    model: object  # the model axis's AxisGroup, or None
    dp: object  # the data-parallel axes' AxisGroup in gspmd mode, else None
    cache: Optional[dict] = None  # the decode cache's spec tree while serving


_ACTIVE: Optional[_Active] = None


def _named(spec) -> set:
    out = set()
    for entry in spec:
        if entry is not None:
            out.update((entry,) if isinstance(entry, str) else entry)
    return out


def computes_split(module, key: str) -> bool:
    """Whether ``module`` computes on its block of parameter ``key`` when
    the key is split over the model axis (else the step gathers it)."""
    return key in getattr(type(module), "tp_keys", ())


@contextlib.contextmanager
def on_mesh(model, mesh, specs: dict, *, global_dp: bool = True,
            cache_specs: Optional[dict] = None):
    """Run the model functions of ``model`` (a ``Transformer``) as one rank
    of ``mesh`` with its parameters split as ``specs`` say (see the module
    docstring). ``global_dp``: the forward is the global program over the
    data-parallel ranks (gspmd mode). ``cache_specs``: the decode cache's
    spec tree, for prefill and decode."""
    global _ACTIVE
    from repro_torch.launch.mesh import axis_group

    if _ACTIVE is not None:
        raise RuntimeError("on_mesh does not nest")
    names = {id(m): (f"{n}." if n else "") for n, m in model.named_modules()}
    dp = axis_group(mesh, ("pod", "data"))
    _ACTIVE = _Active(mesh, specs, names, axis_group(mesh, (MODEL,)), dp if global_dp else None,
                      cache_specs)
    try:
        yield _ACTIVE
    finally:
        _ACTIVE = None


def active() -> bool:
    return _ACTIVE is not None


def tp_group(p, key: str):
    a = _ACTIVE
    if a is None or a.model is None:
        return None
    prefix = a.names.get(id(p))
    if prefix is None or not computes_split(p, key):
        return None
    spec = a.specs.get(prefix + key)
    return a.model if spec is not None and MODEL in _named(spec) else None


def dp_group():
    return None if _ACTIVE is None else _ACTIVE.dp


def active_mesh():
    return None if _ACTIVE is None else _ACTIVE.mesh


def model_group():
    """The model axis's group on a mesh (None off one, or without the axis)."""
    return None if _ACTIVE is None else _ACTIVE.model


def cache_specs() -> Optional[dict]:
    """The decode cache's spec tree while serving on a mesh, else None."""
    return None if _ACTIVE is None else _ACTIVE.cache


def copy_to(x, ag):
    from repro_torch.launch import sharding

    return sharding.copy_to(x, ag, _ACTIVE.mesh)


def reduce_from(x, ag):
    from repro_torch.launch import sharding

    return sharding.reduce_from(x, ag, _ACTIVE.mesh)


def psum(x, ag):
    from repro_torch.launch import sharding

    return sharding.psum(x, ag, _ACTIVE.mesh)


def all_gather_rows(t, ag):
    """Every rank's ``t`` stacked on a new dim 0 in the group's order (no
    autograd)."""
    from repro_torch.launch import sharding

    return sharding.all_gather(t[None], ag, _ACTIVE.mesh)


def gather_vocab(logits, ag):
    """Vocab-split logits made whole (inference: no autograd)."""
    return all_gather(logits, ag, dim=-1)


def all_gather(t, ag, dim: int):
    """Every rank's ``t`` concatenated on ``dim`` in the group's order
    (inference: no autograd)."""
    from repro_torch.launch import sharding

    return sharding.all_gather(t, ag, _ACTIVE.mesh, dim=dim)


def all_reduce(t, ag, op=None):
    """``t`` reduced over the group, a sum unless ``op`` (inference: no
    autograd)."""
    from repro_torch.launch import sharding

    return sharding.all_reduce(t, ag, _ACTIVE.mesh, op or torch.distributed.ReduceOp.SUM)


def gather_slice(t, ag, dim: int):
    """This rank's slice made whole for a computation every rank of the
    group repeats (backward: the rank's slice of the gradient)."""
    from repro_torch.launch import sharding

    return sharding.gather_slice(t, ag, _ACTIVE.mesh, dim)


def my_slice(t, ag, dim: int):
    """This rank's block along ``dim`` of a replicated ``t`` that enters a
    split computation (its gradient all-reduced over the group, so each
    rank's block of it is summed into the whole)."""
    n = t.shape[dim] // ag.size
    return copy_to(t, ag).narrow(dim, ag.index * n, n)


class _VocabCrossEntropy(torch.autograd.Function):
    """(lse, gold) of vocab-split float32 logits, as ``torch.logsumexp`` and
    ``torch.gather`` compute them on whole logits: the max, the sum of
    exponentials and the gold logit reduced over the model axis. The
    backward is theirs, on this rank's columns: exp(lf - lse) for the lse,
    the one-hot of a label in this rank's range for the gold."""

    @staticmethod
    def forward(ctx, lf, labels, ag, mesh):
        from repro_torch.launch.sharding import all_reduce

        v = lf.shape[-1]
        m = all_reduce(torch.amax(lf, dim=-1), ag, mesh, torch.distributed.ReduceOp.MAX)
        m = torch.where(m.abs() == float("inf"), torch.zeros_like(m), m)
        s = all_reduce(torch.exp(lf - m[..., None]).sum(-1), ag, mesh)
        lse = torch.log(s) + m
        ids = labels.long() - ag.index * v
        mine = (ids >= 0) & (ids < v)
        ids = torch.where(mine, ids, torch.zeros_like(ids))
        gold = torch.gather(lf, -1, ids[..., None])[..., 0] * mine.to(lf.dtype)
        gold = all_reduce(gold, ag, mesh)
        ctx.save_for_backward(lf, lse, ids, mine)
        return lse, gold

    @staticmethod
    def backward(ctx, g_lse, g_gold):
        lf, lse, ids, mine = ctx.saved_tensors
        grad = g_lse[..., None] * torch.exp(lf - lse[..., None])
        grad.scatter_add_(-1, ids[..., None], (g_gold * mine.to(g_gold.dtype))[..., None])
        return grad, None, None, None


def vocab_lse_gold(lf, labels, ag):
    return _VocabCrossEntropy.apply(lf, labels, ag, _ACTIVE.mesh)
