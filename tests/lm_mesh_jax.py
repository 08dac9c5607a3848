"""repro's references for tests/test_torch_lm_mesh.py, in subprocesses of
their own (8 fake CPU devices), so that they compile beside the spawned
worlds:

  * ``mesh``: repro's GSPMD train step (``make_train_step(cfg, tcfg, mesh,
    specs)``) of the llama3.2-1b smoke config at fp32 on a (2, 2, 2) mesh of
    ``AxisType.Auto`` axes under ``jax.set_mesh`` (with ``jax.make_mesh``'s
    default axes the step fails at the embedding gather on jax 0.9.0), and
    ``compressed_psum_mean`` under a pure data-parallel ``jax.shard_map``
    over 4 devices, with the int32 payload it sums;
  * ``steps``: repro's one-device train step (``make_train_step(cfg, tcfg,
    None)``) of each named case on the global batches, from the case's
    parameters in the inputs.

    python -m tests.lm_mesh_jax DIR mesh          (writes DIR/jax_mesh.npz)
    python -m tests.lm_mesh_jax DIR steps CASES   (CASES: JSON {name: [arch,
        smoke-config overrides, microbatches]}; writes DIR/jax_steps_<first name>.npz)
"""

from __future__ import annotations

import os

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import dataclasses  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P  # noqa: E402

from repro.configs import get_smoke_config  # noqa: E402
from repro.models import transformer as tfm  # noqa: E402
from repro.models.layers import ShardCtx  # noqa: E402
from repro.training import optimizer as opt  # noqa: E402
from repro.training.grad_compression import compressed_psum_mean, quantize_int8  # noqa: E402
from repro.training.train_loop import TrainConfig, make_train_step  # noqa: E402

# the constants of tests/torch_dist_ranks.py (that module imports torch)
LM_STEPS = 2
LM_OPT = dict(lr=3e-4, warmup_steps=2, total_steps=10)
CMP_LEAVES = ("a", "b", "c")


def unflatten(inp, prefix: str) -> dict:
    tree: dict = {}
    for key in inp:
        if key.startswith(prefix + "/"):
            node = tree
            parts = key[len(prefix) + 1:].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = jnp.asarray(inp[key])
    return tree


def flatten(tree, prefix: str, out: dict) -> dict:
    for key, sub in tree.items():
        if isinstance(sub, dict):
            flatten(sub, f"{prefix}/{key}", out)
        else:
            out[f"{prefix}/{key}"] = np.asarray(sub)
    return out


def gspmd(inp, out) -> None:
    cfg = dataclasses.replace(get_smoke_config("llama3.2-1b"), dtype="float32")
    mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"), axis_types=(AxisType.Auto,) * 3)
    specs = tfm.param_specs(cfg, ShardCtx(model_size=2, fsdp=cfg.fsdp))
    place = lambda tree, sp: jax.tree.map(lambda a, s: jax.device_put(a, NamedSharding(mesh, s)),
                                          tree, sp, is_leaf=lambda x: isinstance(x, P))
    params = place(unflatten(inp, "llama_params"), specs)
    ocfg = opt.OptConfig(**LM_OPT)
    state = {"params": params, "opt": place(opt.init_opt_state(params, ocfg),
                                            opt.opt_state_specs(specs))}
    step = make_train_step(cfg, TrainConfig(opt=ocfg), mesh, specs)
    losses, norms = [], []
    with jax.set_mesh(mesh):
        for s in range(LM_STEPS):
            tokens = jax.device_put(jnp.asarray(inp["lm_tokens"][s]),
                                    NamedSharding(mesh, P(("pod", "data"), None)))
            state, met = step(state, {"tokens": tokens})
            losses.append(float(met["loss"]))
            norms.append(float(met["grad_norm"]))
    out["gspmd_loss"], out["gspmd_gnorm"] = np.asarray(losses), np.asarray(norms)
    flatten(jax.tree.map(np.asarray, state["params"]), "gspmd_params", out)


def dp_shard_map(fn, n_out_replicated: int):
    """fn over per-device slices of arrays stacked on a leading dim of 4."""
    def local(*trees):
        res = fn(*jax.tree.map(lambda a: a[0], trees))
        return tuple(jax.tree.map(lambda a: a[None], r) if i >= n_out_replicated else r
                     for i, r in enumerate(res))
    return local


def compressed(inp, out) -> None:
    mesh = jax.make_mesh((4,), ("data",), devices=jax.devices()[:4],
                         axis_types=(AxisType.Explicit,))

    def body(grads, res):
        mean, new_res = compressed_psum_mean(grads, ("data",), res)
        q_sum = jnp.concatenate([jax.lax.psum(quantize_int8(
            grads[k].astype(jnp.float32) + res[k])[0].astype(jnp.int32), "data").reshape(-1)
            for k in CMP_LEAVES])
        return mean, q_sum, new_res

    fn = jax.shard_map(dp_shard_map(body, 2), mesh=mesh, in_specs=(P("data"), P("data")),
                       out_specs=(P(), P(), P("data")), check_vma=False)
    grads = {k: jnp.asarray(inp[f"cmp_g_{k}"]) for k in CMP_LEAVES}
    res = {k: jnp.asarray(inp[f"cmp_r_{k}"]) for k in CMP_LEAVES}
    mean, q_sum, new_res = fn(grads, res)
    out["cmp_q_sum"] = np.asarray(q_sum)
    for k in CMP_LEAVES:
        out[f"cmp_mean_{k}"], out[f"cmp_res_{k}"] = np.asarray(mean[k]), np.asarray(new_res[k])


def one_device_steps(inp, out, cases: dict) -> None:
    for name, (arch, kw, mb) in cases.items():
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32", **kw)
        ocfg = opt.OptConfig(**LM_OPT)
        params = unflatten(inp, f"{name}_params")
        state = {"params": params, "opt": opt.init_opt_state(params, ocfg)}
        step = make_train_step(cfg, TrainConfig(opt=ocfg, microbatches=mb), None, None)
        losses, norms = [], []
        for s in range(LM_STEPS):
            batch = {"tokens": jnp.asarray(inp["lm_tokens"][s])}
            if f"{name}_frontend" in inp:
                batch["frontend"] = jnp.asarray(inp[f"{name}_frontend"][s])
            state, met = step(state, batch)
            losses.append(float(met["loss"]))
            norms.append(float(met["grad_norm"]))
        out[f"{name}_loss"], out[f"{name}_gnorm"] = np.asarray(losses), np.asarray(norms)
        flatten(jax.tree.map(np.asarray, state["params"]), f"{name}_params", out)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    d, part = pathlib.Path(argv[0]), argv[1]
    inp = dict(np.load(d / "inputs.npz"))
    out: dict = {}
    if part == "mesh":
        gspmd(inp, out)
        compressed(inp, out)
        np.savez(d / "jax_mesh.npz", **out)
    else:
        cases = json.loads(argv[2])
        one_device_steps(inp, out, cases)
        np.savez(d / f"jax_steps_{next(iter(cases))}.npz", **out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
