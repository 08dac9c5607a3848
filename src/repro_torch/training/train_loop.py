"""Training step (``repro/training/train_loop.py``): microbatch gradient
accumulation, the remat'd model forward, AdamW, on one device or as one
rank of a device mesh.

The train state is ``{"params": Transformer, "opt": {"m", "v", "step"}}``,
with the moments keyed by the model's parameter names. ``repro`` donates the
state to a jitted step; the port updates it in place and returns it.

On a mesh (``launch.mesh.make_mesh``, axes ``("pod", "data", "model")``)
the step is SPMD: one process per device, each calling the step with the
same global batch and its own blocks of the state (``make_train_state(...,
mesh=)``: the parameters and moments split as ``param_specs`` /
``opt_state_specs`` say). What ``repro``'s GSPMD program gets from XLA, the
port writes out:

  * the model axis: tensor parallelism where the specs split it (attention
    heads, MLP ``d_ff``, the experts, the vocab of the embedding and the
    logits, rwkv6's time- and channel-mix projections;
    ``models.parallel``); a model-split parameter whose module does not
    compute on blocks would be gathered whole on use, its gradient this
    rank's slice (every module the specs split computes on blocks now);
  * the data axis (``cfg.fsdp``): dims that ``ShardCtx.data`` splits are
    all-gathered before use, their gradients reduce-scattered (summed)
    over ``"data"``;
  * the data-parallel axes ``("pod", "data")``: each rank takes its
    row-major block of every microbatch of the global batch, so microbatch
    i is the one-device step's; the gradients are averaged over them, the
    loss reported is the global mean; the MoE's capacity, slot order and
    aux loss are the global batch's (gspmd mode).

AdamW runs on the blocks; the clip norm is that of the whole logical
gradients (``mesh_global_norm``). The result equals ``repro``'s one-device
step on the global batch.

``grad_compression=True`` on a mesh is ``repro``'s manual-DP mode: each
data-parallel rank runs the one-device program on its block of the batch
(parameters gathered over ``"data"``, tensor parallelism as above), the
data-parallel mean goes through ``compressed_psum_mean`` (int8 payload,
error feedback; ``state["residual"]`` appears after the first step, the
rank's own), and the loss is the mean over the data-parallel ranks.
Without a mesh it runs the plain step, as ``repro``'s does.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from repro_torch.models import parallel as par
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import DATA, MODEL, POD, ShardCtx
from repro_torch.training import optimizer as opt


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: opt.OptConfig = opt.OptConfig()
    microbatches: int = 1
    grad_compression: bool = False


def dp_axes_of(mesh) -> tuple[str, ...]:
    return tuple(a for a in (POD, DATA) if a in mesh.mesh_dim_names)


def mesh_shard_ctx(cfg: ModelConfig, mesh) -> ShardCtx:
    """``repro``'s ``ShardCtx`` for a mesh: the model axis's size (16 when
    the mesh has none), FSDP as the config says."""
    from repro_torch.launch.mesh import axis_sizes

    return ShardCtx(model_size=axis_sizes(mesh).get(MODEL, 16), fsdp=cfg.fsdp)


def make_train_state(cfg: ModelConfig, tcfg: TrainConfig, generator: torch.Generator,
                     device=None, mesh=None) -> dict:
    """Random parameters from ``generator`` (``tfm.init_params``) and zero
    optimizer state, on ``device`` (``None`` -> CUDA, or the mesh rank's
    device). With ``mesh``: every rank draws the whole model from the same
    generator and keeps its blocks (``launch.sharding.shard_state``), the
    moments made beside them; the model records its placement
    (``params.placement``), which checkpoints read."""
    if mesh is None:
        params = tfm.init_params(cfg, generator, device)
        return {"params": params,
                "opt": opt.init_opt_state(dict(params.named_parameters()), tcfg.opt)}
    from repro_torch.launch.mesh import mesh_device
    from repro_torch.launch.sharding import StateSharding, shard_state

    dev = mesh_device(mesh) if device is None else torch.device(device)
    if dev.type != mesh.device_type:
        raise ValueError(f"a {mesh.device_type} mesh's state cannot lie on {dev}")
    specs = tfm.param_specs(cfg, mesh_shard_ctx(cfg, mesh))
    params = shard_state(tfm.init_params(cfg, generator, dev), specs, mesh)
    params.placement = StateSharding(mesh, specs)
    return {"params": params, "opt": opt.init_opt_state(dict(params.named_parameters()),
                                                        tcfg.opt)}


def mesh_sharding(cfg: ModelConfig, mesh):
    """The ``StateSharding`` a mesh step places its state by."""
    from repro_torch.launch.sharding import StateSharding

    return StateSharding(mesh, tfm.param_specs(cfg, mesh_shard_ctx(cfg, mesh)))


def _accumulate(run, micro: list):
    """(loss, grads list) summed over the microbatches ``micro`` by
    ``run(mb) -> (loss, grads)``: one microbatch leaves the gradients in the
    parameters' dtype; several sum them in float32 and scale by 1 / n, as
    ``repro``'s scan does."""
    if len(micro) == 1:
        loss, grads = run(micro[0])
        return loss.detach(), list(grads)
    loss_sum, g_sum = None, None
    for mb in micro:
        loss, grads = run(mb)
        if g_sum is None:
            loss_sum = torch.zeros((), dtype=torch.float32, device=loss.device)
            g_sum = [torch.zeros(g.shape, dtype=torch.float32, device=g.device) for g in grads]
        for acc, g in zip(g_sum, grads):
            acc.add_(g.float())
        loss_sum += loss.detach()
    inv = 1.0 / len(micro)
    return loss_sum * inv, [g * inv for g in g_sum]


def _split(batch: dict, n_micro: int) -> list:
    b = batch["tokens"].shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} does not divide into {n_micro} microbatches")
    return [{k: t.reshape((n_micro, b // n_micro) + t.shape[1:])[i] for k, t in batch.items()}
            for i in range(n_micro)]


def _accumulate_grads(loss_fn, params, batch: dict, n_micro: int):
    """(loss, {name: grad}) over ``n_micro`` microbatches of ``batch`` (B
    must divide by ``n_micro``; see ``_accumulate``)."""
    names, leaves = zip(*params.named_parameters())

    def run(mb):
        loss = loss_fn(params, mb)
        return loss, torch.autograd.grad(loss, leaves)

    loss, grads = _accumulate(run, _split(batch, n_micro))
    return loss, dict(zip(names, grads))


# ---------------------------------------------------------------------------
# the mesh step
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _swapped(model, tensors: dict):
    """The model's parameters replaced by ``tensors`` (by name) inside."""
    saved = []
    for name, t in tensors.items():
        mod_name, _, key = name.rpartition(".")
        mod = model.get_submodule(mod_name) if mod_name else model
        saved.append((mod, key, mod._parameters[key]))
        mod._parameters[key] = t
    try:
        yield
    finally:
        for mod, key, p in saved:
            mod._parameters[key] = p


def _for_use(model, specs: dict, mesh, manual: bool):
    """({name: the tensor the forward computes on}, {name: the tensor the
    gradient is taken against}). Dims split over ``"data"`` are gathered:
    through ``gather`` (gradient reduce-scattered over ``"data"``), or, in
    the compressed mode, as new leaves whose gradients stay whole over
    ``"data"``. Model-split dims of modules that do not compute on blocks
    are gathered through ``gather_slice``."""
    from repro_torch.launch.mesh import axis_group
    from repro_torch.launch.sharding import all_gather, gather, gather_slice

    data, model_ag = axis_group(mesh, (DATA,)), axis_group(mesh, (MODEL,))
    used, wrt = {}, {}
    for name, p in model.named_parameters():
        mod_name, _, key = name.rpartition(".")
        mod = model.get_submodule(mod_name) if mod_name else model
        t = p
        spec = specs[name]
        for d, entry in enumerate(spec):
            if entry == DATA and data is not None:
                if manual:
                    t = all_gather(p.detach(), data, mesh, d).requires_grad_()
                else:
                    t = gather(t, data, mesh, d)
        wrt[name] = t if manual else p
        for d, entry in enumerate(spec):
            if entry == MODEL and model_ag is not None and not par.computes_split(mod, key):
                t = gather_slice(t, model_ag, mesh, d)
        used[name] = t
    return used, wrt


@contextlib.contextmanager
def mesh_model(model, mesh, *, global_dp: bool, compressed: bool = False, cache_specs=None):
    """Inside, the model functions run ``model`` (a placed ``Transformer``)
    as this rank of ``mesh``: tensor-parallel where its ``placement``'s
    specs split the model axis, the rest gathered
    (``models.parallel``). ``global_dp``: the forward is the global program
    over the data-parallel ranks, else the one-device program on each
    rank's rows (the compressed mode's step; serving a batch the
    data-parallel ranks do not split). ``compressed``: the gradients stay
    whole over ``"data"`` (``_for_use``). ``cache_specs``: the decode
    cache's, which prefill and decode on the mesh need.
    Yields {name: the tensor gradients are taken against}."""
    specs = model.placement.specs
    with par.on_mesh(model, mesh, specs, global_dp=global_dp, cache_specs=cache_specs):
        used, wrt = _for_use(model, specs, mesh, compressed)
        with _swapped(model, used):
            yield wrt


def mesh_global_norm(grads: dict, specs: dict, mesh) -> torch.Tensor:
    """The global norm of the logical gradients from this rank's blocks:
    each leaf's local sum of squares, reduced over the axes its spec splits
    it on (a replicated leaf counted once), then summed in leaf order as
    ``global_norm`` sums."""
    from repro_torch.launch.mesh import axis_group
    from repro_torch.launch.sharding import all_reduce, spec_axes

    names = list(grads)
    sq = [torch.sum(torch.square(grads[k].float())) for k in names]
    by_axes: dict = {}
    for i, k in enumerate(names):
        axes = tuple(a for a in mesh.mesh_dim_names
                     if any(a in spec_axes(e) for e in specs[k]))
        if axes:
            by_axes.setdefault(axes, []).append(i)
    for axes, idx in by_axes.items():
        summed = all_reduce(torch.stack([sq[i] for i in idx]), axis_group(mesh, axes), mesh)
        for j, i in enumerate(idx):
            sq[i] = summed[j]
    return torch.sqrt(sum(sq))


def _check_state(model, mesh, specs: dict) -> None:
    placement = getattr(model, "placement", None)
    if placement is None or placement.mesh is not mesh or placement.specs != specs:
        raise ValueError("the train state is not placed on this mesh by these specs: make it "
                         "with make_train_state(..., mesh=mesh) or restore it with shardings=")


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, mesh=None, param_specs_tree=None):
    """Returns fn(state, batch) -> (state, metrics): gradients of
    ``make_loss_fn`` over ``tcfg.microbatches``, then one AdamW update of the
    state in place. ``metrics`` holds 0-d tensors ``loss``, ``lr`` and
    ``grad_norm``. With ``mesh``, the step of the module docstring: every
    rank passes the same global batch; ``param_specs_tree``, when given,
    must be ``tfm.param_specs(cfg, mesh_shard_ctx(cfg, mesh))``, the
    placement of ``make_train_state(..., mesh=)``."""
    loss_fn = tfm.make_loss_fn(cfg)
    if mesh is None:

        def step(state: dict, batch: dict):
            params = state["params"]
            loss, grads = _accumulate_grads(loss_fn, params, batch, tcfg.microbatches)
            metrics = opt.adamw_update(grads, state["opt"], dict(params.named_parameters()),
                                       tcfg.opt)
            metrics["loss"] = loss
            return state, metrics

        return step

    from repro_torch.launch.mesh import axis_group
    from repro_torch.launch.sharding import all_reduce, block_of, check_world, dp_block

    if not hasattr(mesh, "mesh_dim_names"):
        raise TypeError(f"mesh must be a DeviceMesh (launch.mesh.make_mesh), not "
                        f"{type(mesh).__name__}")
    check_world(mesh)
    specs = tfm.param_specs(cfg, mesh_shard_ctx(cfg, mesh))
    if param_specs_tree is not None and param_specs_tree != specs:
        raise ValueError("param_specs_tree differs from param_specs(cfg, mesh_shard_ctx(cfg, "
                         "mesh)), by which the train state is placed")
    # every group the step reduces over, made here in one order on every rank
    for axes in ((POD, DATA), (MODEL,), (DATA,), (POD,)):
        axis_group(mesh, axes)
    dp_axes = dp_axes_of(mesh)
    dp = axis_group(mesh, (POD, DATA))
    n_dp = 1 if dp is None else dp.size
    manual = tcfg.grad_compression
    n_micro = tcfg.microbatches

    def grads_on_mesh(model, micro: list):
        def run(mb):
            with mesh_model(model, mesh, global_dp=not manual, compressed=manual) as wrt:
                loss = loss_fn(model, mb)
                return loss, torch.autograd.grad(loss, list(wrt.values()))

        return _accumulate(run, micro)

    def raw_grads(state: dict, batch: dict):
        """(this rank's loss, {name: its gradient before the data-parallel
        reduction}): blocks of the model axis's splits, summed over
        ``"data"`` where FSDP splits (gspmd mode) or whole over it
        (compressed mode)."""
        model = state["params"]
        _check_state(model, mesh, specs)
        b = batch["tokens"].shape[0]
        if b % (n_micro * n_dp):
            raise ValueError(f"global batch {b} does not divide into {n_micro} microbatches "
                             f"over {n_dp} data-parallel ranks")
        if manual:  # repro's shard_map: the rank's block, then its microbatches
            micro = _split({k: dp_block(t, mesh, dp_axes) for k, t in batch.items()}, n_micro)
        else:  # the rank's block of each of the global batch's microbatches
            micro = [{k: dp_block(t, mesh, dp_axes) for k, t in mb.items()}
                     for mb in _split(batch, n_micro)]
        loss, grads = grads_on_mesh(model, micro)
        return loss, dict(zip((n for n, _ in model.named_parameters()), grads))

    def mesh_grads(state: dict, batch: dict):
        """(the global mean loss, {name: this rank's block of the gradient
        AdamW applies}); sets ``state["residual"]`` in the compressed mode."""
        loss, grads = raw_grads(state, batch)
        if manual:
            from repro_torch.training.grad_compression import compressed_psum_mean

            mean, state["residual"] = compressed_psum_mean(grads, dp_axes,
                                                           state.get("residual"), mesh, specs)
            grads = {k: block_of(g, tuple(e if e == DATA else None for e in specs[k]), mesh)
                     for k, g in mean.items()}
        else:  # the data-parallel mean; FSDP leaves are summed over "data" already
            pod = axis_group(mesh, (POD,))
            grads = {k: all_reduce(g.float(), pod if DATA in specs[k] else dp, mesh) * (1.0 / n_dp)
                     for k, g in grads.items()}
        return all_reduce(loss, dp, mesh) / n_dp, grads

    def step(state: dict, batch: dict):
        loss, grads = mesh_grads(state, batch)
        metrics = opt.adamw_update(grads, state["opt"], dict(state["params"].named_parameters()),
                                   tcfg.opt, gnorm=mesh_global_norm(grads, specs, mesh))
        metrics["loss"] = loss
        return state, metrics

    step.raw_grads = raw_grads
    step.grads = mesh_grads
    return step
