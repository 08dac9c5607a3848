"""Device meshes of the port (``repro/launch/mesh.py``) and the collectives
the index side runs over them (the LM side's, with placement, are in
``launch/sharding.py``).

``repro`` runs one controller over many devices and names them with a
``jax.sharding.Mesh``. The port runs SPMD: one process per device, a
``torch.distributed`` process group across them, and a ``DeviceMesh`` naming
the same axes (``"pod"``, ``"data"``, ``"model"``). A mesh on ``"cuda"`` runs
NCCL with rank r on ``cuda:{LOCAL_RANK}``; a mesh on ``"cpu"`` runs gloo and
exists only when the caller asks for it (tests, ``--device cpu``). A dry
mesh (``dry=True``, device type ``"meta"``) runs a fake process group whose
collectives do nothing, over as many ranks as the mesh has; this process is
one of them (rank 0 unless told): the dry run (``launch/dryrun.py``)
evaluates a rank's program there on meta tensors, allocating nothing. It is
only ever asked for. Nothing falls back: a missing NCCL, a process group of another backend, or a world
size other than the mesh's raises, and a tensor on another device type than
the mesh's never enters a collective.

Groups over a combination of axes (``axis_group``) list their ranks in
row-major order of the combined coordinate, so an all-gather over the
segment axes returns the segments in segment order. ``make_mesh`` creates
the groups of the data-parallel axes and of the model axis when it makes the
mesh, with the process group's timeout: every rank makes it at the same
point. Nothing here touches device or process
group state at import time.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import weakref
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

DEFAULT_TIMEOUT_S = 120.0  # a rank left alone in a collective raises after this
_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


@dataclasses.dataclass(frozen=True)
class AxisGroup:
    """The process group over a combination of mesh axes, as seen by this
    rank: ``size`` ranks, this rank at ``index`` (its row-major coordinate
    over the axes). A group of one still runs its collectives."""

    axes: tuple[str, ...]
    size: int
    index: int
    group: dist.ProcessGroup


# per mesh: {axes: AxisGroup}, filled when the mesh is made (or on first use
# for a DeviceMesh made elsewhere); dies with the mesh
_GROUPS: "weakref.WeakKeyDictionary[DeviceMesh, dict]" = weakref.WeakKeyDictionary()
_TIMEOUTS: "weakref.WeakKeyDictionary[DeviceMesh, float]" = weakref.WeakKeyDictionary()


def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def mesh_dp_size(mesh) -> int:
    """Devices on the data-parallel axes ("pod" x "data")."""
    sizes = axis_sizes(mesh)
    out = 1
    for a in ("pod", "data"):
        out *= sizes.get(a, 1)
    return out


def mesh_model_size(mesh) -> int:
    return axis_sizes(mesh).get("model", 1)


def mesh_device(mesh) -> torch.device:
    """This rank's device: its current CUDA device on a cuda mesh."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _local_cuda_index(rank: int) -> int:
    local = os.environ.get("LOCAL_RANK")
    return int(local) if local is not None else rank % max(torch.cuda.device_count(), 1)


def _init_process_group(device_type: str, store, rank, world_size, timeout_s: float) -> None:
    backend = _BACKEND[device_type]
    if device_type == "cuda" and not dist.is_nccl_available():
        raise RuntimeError("a cuda mesh runs NCCL, and this torch has no NCCL")
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(
                f"a {device_type} mesh runs {backend}; the process group runs "
                f"{dist.get_backend()}")
        return
    kwargs = dict(backend=backend, timeout=datetime.timedelta(seconds=timeout_s))
    if store is not None:
        if rank is None or world_size is None:
            raise ValueError("an explicit store needs rank and world_size")
        kwargs.update(store=store, rank=rank, world_size=world_size)
    else:  # torchrun's environment
        kwargs.update(init_method="env://")
    if device_type == "cuda":
        r = rank if rank is not None else int(os.environ.get("RANK", "0"))
        kwargs["device_id"] = torch.device("cuda", _local_cuda_index(r))
    dist.init_process_group(**kwargs)


def make_mesh(
    shape: Sequence[int],
    axis_names: Sequence[str],
    *,
    device_type: str = "cuda",
    store=None,
    rank: Optional[int] = None,
    world_size: Optional[int] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
    dry: bool = False,
) -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` named ``axis_names`` over the world.

    Opens the process group when none is open: from ``store`` / ``rank`` /
    ``world_size`` when given, else from torchrun's environment. NCCL on
    ``"cuda"`` (this rank's device set to ``cuda:{LOCAL_RANK}``), gloo on
    ``"cpu"``; ``timeout_s`` bounds every collective of the mesh. The world
    must hold exactly ``prod(shape)`` ranks. Every rank calls this at the
    same point: it creates the mesh's groups. ``dry``: a fake world of
    ``prod(shape)`` ranks on ``"meta"`` (see the module docstring), this
    process its rank ``rank`` (default 0)."""
    if dry:
        return _make_dry_mesh(shape, axis_names, device_type, rank or 0)
    if device_type not in _BACKEND:
        raise ValueError(f"device_type must be one of {sorted(_BACKEND)}, got {device_type!r}")
    shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
    if len(shape) != len(axis_names):
        raise ValueError(f"shape {shape} and axis names {axis_names} differ in length")
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a cuda mesh needs CUDA, which is not available")
    _init_process_group(device_type, store, rank, world_size, timeout_s)
    if device_type == "cuda":
        torch.cuda.set_device(_local_cuda_index(dist.get_rank()))
    n = int(np.prod(shape))
    if dist.get_world_size() != n:
        raise ValueError(
            f"a mesh of shape {shape} needs a world of {n} ranks, not {dist.get_world_size()}")
    mesh = DeviceMesh(device_type, torch.arange(n).reshape(shape), mesh_dim_names=axis_names)
    _TIMEOUTS[mesh] = float(timeout_s)
    # the groups the index side gathers over, in one order on every rank: the
    # data-parallel axes (segments) and the model axis (query rows)
    for axes in (("pod", "data"), ("model",)):
        axis_group(mesh, axes)
    return mesh


def _make_dry_mesh(shape, axis_names, device_type: str, rank: int) -> DeviceMesh:
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if device_type != "meta":
        raise ValueError(f"a dry mesh holds meta tensors, not {device_type!r} ones")
    shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
    n = int(np.prod(shape))
    if dist.is_initialized():
        if dist.get_backend() != "fake" or dist.get_world_size() != n:
            raise RuntimeError(f"a dry mesh of {n} ranks needs a fake process group of as many; "
                               f"one of {dist.get_backend()} over {dist.get_world_size()} is open")
    else:
        dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=n)
    mesh = DeviceMesh("meta", torch.arange(n).reshape(shape), mesh_dim_names=axis_names)
    for axes in (("pod", "data"), ("model",)):
        axis_group(mesh, axes)
    return mesh


def make_production_mesh(*, multi_pod: bool = False, **kwargs) -> DeviceMesh:
    """16 x 16 = 256 devices a pod; multi-pod adds the pod axis (repro's
    shapes). Needs a world of 256 (512) ranks, or ``dry=True``; ``kwargs``
    go to ``make_mesh``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, **kwargs)


def mesh_timeout_s(mesh) -> float:
    """Seconds a collective of this mesh waits for the other ranks."""
    return _TIMEOUTS.get(mesh, DEFAULT_TIMEOUT_S)


def axis_coordinate(mesh, axes: Sequence[str], rank: int) -> int:
    """Rank ``rank``'s row-major coordinate over the mesh axes in ``axes``
    that the mesh has (0 when it has none)."""
    names = tuple(mesh.mesh_dim_names)
    grid = mesh.mesh.cpu().numpy()
    pos = np.argwhere(grid == rank)[0]
    dims = [names.index(a) for a in axes if a in names]
    if not dims:
        return 0
    return int(np.ravel_multi_index(tuple(pos[d] for d in dims), tuple(grid.shape[d] for d in dims)))


def axis_group(mesh, axes: Sequence[str]) -> Optional[AxisGroup]:
    """The group over the mesh axes in ``axes`` that the mesh has (None if
    it has none of them), ranks in row-major order of their coordinate over
    those axes. Creating one is collective: every rank asks for the same
    axes in the same order (``make_mesh`` creates the two the index side
    uses up front)."""
    names = tuple(mesh.mesh_dim_names)
    present = tuple(a for a in axes if a in names)
    if not present:
        return None
    groups = _GROUPS.setdefault(mesh, {})
    if present in groups:
        return groups[present]
    grid = mesh.mesh.cpu().numpy()
    dims = [names.index(a) for a in present]
    rest = [d for d in range(grid.ndim) if d not in dims]
    # rows: one rank list per setting of the other axes, in row-major order
    # of the combined coordinate over ``present``
    lists = grid.transpose(rest + dims).reshape(-1, int(np.prod([grid.shape[d] for d in dims])))
    if any(row != sorted(row) for row in lists.tolist()):
        raise NotImplementedError(
            f"mesh ranks must grow with the coordinate over {present} (a row-major mesh)")
    group, _ = dist.new_subgroups_by_enumeration(
        lists.tolist(), timeout=datetime.timedelta(seconds=mesh_timeout_s(mesh)))
    ag = AxisGroup(present, lists.shape[1], axis_coordinate(mesh, present, dist.get_rank()),
                   group)
    groups[present] = ag
    return ag


def _check_device(mesh, t: torch.Tensor) -> None:
    if t.device.type != mesh.device_type:
        raise ValueError(
            f"a {t.device.type} tensor cannot enter a {mesh.device_type} mesh's collective")


def _wire(t: torch.Tensor) -> torch.Tensor:
    """The tensor as it travels: contiguous, bool as uint8."""
    t = t.contiguous()
    return t.view(torch.uint8) if t.dtype == torch.bool else t


def all_gather_cat(mesh, t: torch.Tensor, ag: AxisGroup) -> torch.Tensor:
    """Every rank's ``t`` concatenated on axis 0 in the group's order."""
    _check_device(mesh, t)
    w = _wire(t)
    parts = [torch.empty_like(w) for _ in range(ag.size)]
    dist.all_gather(parts, w, group=ag.group)
    out = torch.cat(parts)
    return out.view(torch.bool) if t.dtype == torch.bool else out


def all_reduce_sum(mesh, t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over every rank of the mesh (the world)."""
    _check_device(mesh, t)
    t = t.clone()
    dist.all_reduce(t)
    return t


def broadcast_object(obj, src: int = 0):
    """``obj`` from rank ``src`` to every rank (pickled; rank ``src``'s own
    programs are the only writers)."""
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def tensor_specs(tensors: Sequence[torch.Tensor]) -> list[tuple[tuple[int, ...], torch.dtype]]:
    return [(tuple(t.shape), t.dtype) for t in tensors]


def broadcast_tensors(mesh, tensors: Optional[Sequence[torch.Tensor]], specs,
                      src: int = 0) -> list[torch.Tensor]:
    """Rank ``src`` sends ``tensors``; every other rank receives tensors of
    ``specs`` (shape, dtype) on its own device."""
    dev = mesh_device(mesh)
    out = []
    for i, (shape, dtype) in enumerate(specs):
        if dist.get_rank() == src:
            t = tensors[i]
            _check_device(mesh, t)
        else:
            t = torch.empty(shape, dtype=dtype, device=dev)
        w = _wire(t)
        dist.broadcast(w, src=src)
        out.append(t)
    return out


def send_tensors(mesh, tensors: Sequence[torch.Tensor], dst: int) -> None:
    for t in tensors:
        _check_device(mesh, t)
        dist.send(_wire(t), dst=dst)


def recv_tensors(mesh, specs, src: int = 0) -> list[torch.Tensor]:
    dev = mesh_device(mesh)
    out = []
    for shape, dtype in specs:
        t = torch.empty(shape, dtype=dtype, device=dev)
        dist.recv(_wire(t), src=src)
        out.append(t)
    return out
