"""Placement of a train state and of a decode cache on a device mesh, and
the collectives of a mesh step (``repro``'s ``NamedSharding`` placement and
what GSPMD inserts).

A spec (``models.layers.P``) has one entry per dim: an axis name, a tuple of
axis names (the dim split over their row-major product, as ``batch_spec``
splits the batch over ``("pod", "data")``) or ``None``. ``shard_state``
keeps this rank's block of every leaf: along each spec'd dim, block
``index`` of ``size`` where ``size`` is the product of the named axes the
mesh has and ``index`` the rank's row-major coordinate over them. The blocks
are plain tensors on the rank's device; a dim that its axes do not divide
raises, and so does a leaf on another device type than the mesh's.

The collectives are ``torch.autograd.Function``s over a mesh's axis groups
(``launch.mesh.axis_group``), each with its conjugate backward. A mesh step
differentiates one objective per rank, and the step sums them over the
data-parallel ranks (a mean, once divided) while the model ranks hold the
same objective:

  ``copy_to``      identity; backward: all-reduce sum. A replicated tensor
                   entering a model-split computation.
  ``reduce_from``  all-reduce sum; backward: identity. Partial results of a
                   model-split computation made replicated.
  ``psum``         all-reduce sum; backward: all-reduce sum. A sum over the
                   data-parallel ranks that every rank's objective reads.
  ``gather``       all-gather; backward: reduce-scatter sum. FSDP: a
                   parameter split over ``"data"``, whose ranks see other
                   batch blocks (the reduce-scatter is this conjugate).
  ``gather_slice`` all-gather; backward: this rank's slice. A model-split
                   parameter gathered on use: every model rank computes the
                   same thing on the same data, so the gradients are whole
                   already and a sum would scale them by the model size.

A decode cache is placed by a tree of ``NamedSharding`` (``repro``'s
``cache_shardings``, ``serving.engine``): ``shard_cache`` / ``gather_cache``
are ``shard_state`` / ``gather_state`` over such a tree.

Nothing here touches device or process-group state at import time.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from repro_torch.launch.mesh import AxisGroup, _check_device, axis_group


# ---------------------------------------------------------------------------
# specs on a mesh
# ---------------------------------------------------------------------------


def spec_axes(entry) -> tuple[str, ...]:
    """The axis names of one spec entry (``None`` -> ())."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def dim_group(mesh, entry) -> Optional[AxisGroup]:
    """The group a spec entry splits its dim over (None: replicated, or none
    of its axes on the mesh)."""
    axes = spec_axes(entry)
    return axis_group(mesh, axes) if axes else None


def _dim_groups(mesh, spec, shape) -> list[tuple[int, AxisGroup]]:
    """[(dim, group)] of the spec'd dims; raises where a dim does not divide."""
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than the leaf's dims {tuple(shape)}")
    out = []
    for d, entry in enumerate(spec):
        ag = dim_group(mesh, entry)
        if ag is None:
            continue
        if shape[d] % ag.size:
            raise ValueError(f"dim {d} of {tuple(shape)} (spec {spec}) does not divide over "
                             f"{ag.axes} of size {ag.size}")
        out.append((d, ag))
    return out


def local_shape(shape, spec, mesh) -> tuple[int, ...]:
    """The block's shape of a leaf of ``shape`` under ``spec``."""
    out = list(shape)
    for d, ag in _dim_groups(mesh, spec, shape):
        out[d] //= ag.size
    return tuple(out)


def block_of(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of the whole leaf ``t`` (a view)."""
    for d, ag in _dim_groups(mesh, spec, t.shape):
        n = t.shape[d] // ag.size
        t = t.narrow(d, ag.index * n, n)
    return t


def check_world(mesh) -> None:
    if not dist.is_initialized() or dist.get_world_size() != mesh.mesh.numel():
        world = dist.get_world_size() if dist.is_initialized() else None
        raise ValueError(f"a mesh of {mesh.mesh.numel()} devices needs a world of as many "
                         f"ranks, not {world}")


# ---------------------------------------------------------------------------
# plain collectives (no autograd)
# ---------------------------------------------------------------------------


def all_reduce(t: torch.Tensor, ag: Optional[AxisGroup], mesh,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced over the group (a new tensor; ``t`` itself without a
    group)."""
    if ag is None:
        return t
    _check_device(mesh, t)
    out = t.contiguous().clone()
    dist.all_reduce(out, op=op, group=ag.group)
    return out


def all_gather(t: torch.Tensor, ag: Optional[AxisGroup], mesh, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` concatenated on ``dim`` in the group's order (over
    a group of one, ``t`` itself: no copy of a whole parameter)."""
    if ag is None or ag.size == 1:
        _check_device(mesh, t)
        return t
    _check_device(mesh, t)
    w = t.contiguous()
    parts = [torch.empty_like(w) for _ in range(ag.size)]
    dist.all_gather(parts, w, group=ag.group)
    return torch.cat(parts, dim=dim)


def reduce_scatter(t: torch.Tensor, ag: Optional[AxisGroup], mesh, dim: int = 0) -> torch.Tensor:
    """The sum over the group of ``t``, this rank's block along ``dim``.
    NCCL reduce-scatters; gloo, which has no reduce-scatter, all-reduces and
    keeps the block."""
    if ag is None or ag.size == 1:
        _check_device(mesh, t)
        return t
    n = t.shape[dim] // ag.size
    if mesh.device_type == "cuda":
        w = t.movedim(dim, 0).contiguous()
        out = torch.empty((n,) + w.shape[1:], dtype=w.dtype, device=w.device)
        dist.reduce_scatter_tensor(out, w, group=ag.group)
        return out.movedim(0, dim)
    return all_reduce(t, ag, mesh).narrow(dim, ag.index * n, n).contiguous()


# ---------------------------------------------------------------------------
# autograd collectives
# ---------------------------------------------------------------------------


def _fresh(out: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A Function's output that is its input (a group of one) as a view."""
    return x.view_as(x) if out is x else out


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ag, mesh):
        ctx.ag, ctx.mesh = ag, mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.ag, ctx.mesh), None, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ag, mesh):
        return all_reduce(x, ag, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ag, mesh):
        ctx.ag, ctx.mesh = ag, mesh
        return all_reduce(x, ag, mesh)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.ag, ctx.mesh), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ag, mesh, dim):
        ctx.ag, ctx.mesh, ctx.dim = ag, mesh, dim
        return _fresh(all_gather(x, ag, mesh, dim), x)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.ag, ctx.mesh, ctx.dim), None, None, None


class _GatherSlice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ag, mesh, dim):
        ctx.ag, ctx.dim, ctx.n = ag, dim, x.shape[dim]
        return _fresh(all_gather(x, ag, mesh, dim), x)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.ag.index * ctx.n, ctx.n), None, None, None


def copy_to(x, ag: AxisGroup, mesh):
    return _Copy.apply(x, ag, mesh)


def reduce_from(x, ag: AxisGroup, mesh):
    return _Reduce.apply(x, ag, mesh)


def psum(x, ag: AxisGroup, mesh):
    return _PSum.apply(x, ag, mesh)


def gather(x, ag: AxisGroup, mesh, dim: int):
    return _Gather.apply(x, ag, mesh, dim)


def gather_slice(x, ag: AxisGroup, mesh, dim: int):
    return _GatherSlice.apply(x, ag, mesh, dim)


# ---------------------------------------------------------------------------
# train states
# ---------------------------------------------------------------------------


def train_state_specs(param_specs: dict) -> dict:
    """The specs of a train state ``{"params", "opt": {"m", "v", "step"}}``:
    the moments split as their parameters (``opt_state_specs``)."""
    from repro_torch.training.optimizer import opt_state_specs

    return {"params": param_specs, "opt": opt_state_specs(param_specs)}


def _set_param(model: nn.Module, name: str, value: torch.Tensor) -> None:
    mod_name, _, key = name.rpartition(".")
    mod = model.get_submodule(mod_name) if mod_name else model
    mod._parameters[key] = nn.Parameter(value, requires_grad=True)


def _map_leaves(fn, tree, specs, what: str):
    """``fn(leaf, spec)`` over a tree of dicts (and a ``Transformer`` under
    ``"params"``, mapped in place), specs in a tree of the same keys."""
    from repro_torch.models.transformer import Transformer

    if isinstance(tree, Transformer):
        names = dict(tree.named_parameters())
        if set(names) != set(specs):
            raise ValueError(f"{what}: the specs name other parameters than the model's")
        for name, p in names.items():
            _set_param(tree, name, fn(p.detach(), specs[name]))
        return tree
    if isinstance(tree, dict):
        missing = set(tree) - set(specs)
        if missing:
            raise ValueError(f"{what}: no spec for {sorted(missing)}")
        return {k: _map_leaves(fn, v, specs[k], what) for k, v in tree.items()}
    return fn(tree, specs)


def shard_state(tree, specs, mesh):
    """Keep this rank's block of every leaf of ``tree`` (nested dicts of
    tensors; a ``Transformer`` has its parameters replaced in place by their
    blocks) under ``specs`` (the same keys, a spec per leaf; a
    ``Transformer``'s keyed by parameter name). Every rank holds the whole
    tree first: a model that one device holds, initialised whole and then
    sliced, is what this slice's sizes ask for. Collective only in creating
    the axis groups, in the same order on every rank."""
    check_world(mesh)

    def keep(t, spec):
        _check_device(mesh, t)
        return block_of(t, spec, mesh).clone()

    return _map_leaves(keep, tree, specs, "shard_state")


def gather_state(tree, specs, mesh):
    """The inverse of ``shard_state``: every leaf whole on every rank (a
    ``Transformer`` comes back as a new one; ``tree`` is left as it was, and
    a leaf that no axis of more than one rank splits comes back as the same
    tensor, not a copy)."""
    from repro_torch.models.transformer import Transformer

    check_world(mesh)

    def whole(t, spec):
        for d, ag in reversed(_dim_groups_local(mesh, spec, t.ndim)):
            t = all_gather(t, ag, mesh, d)
        return t

    if isinstance(tree, Transformer):
        out = Transformer(tree.cfg, torch.device("meta"))
        for name, p in tree.named_parameters():
            _set_param(out, name, whole(p.detach(), specs[name]))
        return out
    if isinstance(tree, dict):
        return {k: gather_state(v, specs[k], mesh) for k, v in tree.items()}
    return whole(tree, specs)


def _dim_groups_local(mesh, spec, ndim: int) -> list[tuple[int, AxisGroup]]:
    return [(d, ag) for d, ag in ((d, dim_group(mesh, e)) for d, e in enumerate(spec[:ndim]))
            if ag is not None]


def dp_block(t: torch.Tensor, mesh, axes: Sequence[str] = ("pod", "data")) -> torch.Tensor:
    """This rank's row-major block of ``t`` along dim 0 over the
    data-parallel axes (``repro``'s ``batch_spec``)."""
    return block_of(t, (tuple(axes),), mesh)


@dataclasses.dataclass(frozen=True, eq=False)
class StateSharding:
    """Where a train state lives: ``mesh`` and the parameter specs it is
    split by (``shardings=`` of the checkpoints; a mesh state's model
    carries it as ``placement``)."""

    mesh: object
    specs: dict

    def tree_specs(self) -> dict:
        return train_state_specs(self.specs)


def place_model(model, sharding: StateSharding):
    """A whole model (every rank's the same) cut to this rank's blocks in
    place, recording ``placement`` (what ``ServingEngine(mesh=)`` serves)."""
    out = shard_state(model, sharding.specs, sharding.mesh)
    out.placement = sharding
    return out


def place_state(state: dict, sharding: StateSharding) -> dict:
    """A whole train state (every rank's the same) cut to this rank's blocks
    (``shard_state``), its model recording ``placement``."""
    out = shard_state({"params": state["params"], "opt": state["opt"]}, sharding.tree_specs(),
                      sharding.mesh)
    out["params"].placement = sharding
    return out


# ---------------------------------------------------------------------------
# decode caches
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class NamedSharding:
    """Where one leaf lives on a mesh: ``repro``'s
    ``jax.sharding.NamedSharding(mesh, spec)``, seen from this rank."""

    mesh: object
    spec: tuple

    def shard_shape(self, shape) -> tuple[int, ...]:
        """The block's shape of a leaf of ``shape`` (raises where a split dim
        does not divide)."""
        return local_shape(shape, self.spec, self.mesh)


def _specs_of(shardings):
    return ({k: _specs_of(v) for k, v in shardings.items()} if isinstance(shardings, dict)
            else shardings.spec)


def _mesh_of(shardings):
    while isinstance(shardings, dict):
        shardings = next(iter(shardings.values()))
    return shardings.mesh


def shard_cache(cache: dict, shardings: dict) -> dict:
    """This rank's block of every leaf of a whole cache (``shard_state``
    over a tree of ``NamedSharding``)."""
    return shard_state(cache, _specs_of(shardings), _mesh_of(shardings))


def gather_cache(cache: dict, shardings: dict) -> dict:
    """Every leaf whole on every rank from the rank's blocks (collective)."""
    return gather_state(cache, _specs_of(shardings), _mesh_of(shardings))
