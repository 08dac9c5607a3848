"""repro's references for tests/test_torch_lm_serve_mesh.py, in a
subprocess of its own (8 fake CPU devices), beside the spawned worlds.

For each case (JSON ``{name: [arch, smoke-config overrides, batch, prompt,
new tokens, max_len, [mesh shapes], auto mesh shape or null]}``), from the
case's parameters, prompts and frontend in ``DIR/inputs.npz``:

  * repro's one-device ``ServingEngine``: the tokens, and the logits each
    step sampled from;
  * repro's one-device prefill cache, cut into the block of every device of
    a mesh of each shape (axes ``("pod", "data", "model")``) by
    ``NamedSharding(mesh, spec).devices_indices_map`` under
    ``cache_specs`` at that mesh's sizes (device i is the port's rank i:
    both meshes are row-major);
  * with an auto mesh shape, repro's ``ServingEngine(mesh=)`` on a mesh of
    that shape with ``AxisType.Auto`` axes under ``jax.set_mesh``, its parameters
    placed by ``param_specs``: the tokens and logits.

    python -m tests.serve_mesh_jax DIR CASES   (writes DIR/jax_serve_<first name>.npz)
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
from repro.serving.engine import ServeConfig, ServingEngine  # noqa: E402
from tests.lm_mesh_jax import unflatten  # noqa: E402

AXES = ("pod", "data", "model")


def generate(eng, prompts, n: int, frontend):
    """(tokens, the logits of every sampling step) of ``eng.generate``."""
    seen, sample = [], eng._sample

    def record(logits, key):
        seen.append(np.asarray(logits))
        return sample(logits, key)

    eng._sample = record
    toks = eng.generate(prompts, n, frontend=frontend)
    return np.asarray(toks), np.stack(seen)


def blocks(cfg, cache, b: int, max_len: int, shape, out: dict, prefix: str) -> None:
    mesh = jax.make_mesh(shape, AXES, devices=jax.devices()[:int(np.prod(shape))])
    specs = tfm.cache_specs(cfg, b, max_len, dp_size=shape[0] * shape[1],
                            model_size=shape[2], multi_pod=True)
    devices = list(mesh.devices.flat)
    for g, tree in cache.items():
        for k, leaf in tree.items():
            index = NamedSharding(mesh, specs[g][k]).devices_indices_map(leaf.shape)
            for r, dev in enumerate(devices):
                out[f"{prefix}_block{r}/{g}/{k}"] = np.asarray(leaf[index[dev]])


def run(inp, name: str, case, out: dict) -> None:
    arch, kw, b, lp, n, max_len, shapes, auto = case
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32", **kw)
    if cfg.moe_impl == "ep_manual":  # repro's needs a mesh; without drops gspmd's equals it
        cfg = dataclasses.replace(cfg, moe_impl="gspmd")
    params = unflatten(inp, f"serve_{name}_params")
    prompts = jnp.asarray(inp[f"serve_{name}_prompts"])
    fe = inp.get(f"serve_{name}_frontend")
    fe = None if fe is None else jnp.asarray(fe)
    scfg = ServeConfig(max_len=max_len, batch=b)
    out[f"{name}_tokens"], out[f"{name}_logits"] = generate(
        ServingEngine(cfg, params, scfg), prompts, n, fe)
    cache = jax.jit(tfm.make_prefill(cfg, max_len))(params, prompts, fe)[1]
    for shape in shapes:
        blocks(cfg, cache, b, max_len, tuple(shape), out, f"{name}_{'x'.join(map(str, shape))}")
    if auto:
        mesh = jax.make_mesh(tuple(auto), AXES, axis_types=(AxisType.Auto,) * 3)
        specs = tfm.param_specs(cfg, ShardCtx(model_size=auto[2], fsdp=cfg.fsdp))
        placed = jax.tree.map(lambda a, s: jax.device_put(a, NamedSharding(mesh, s)), params,
                              specs, is_leaf=lambda x: isinstance(x, P))
        with jax.set_mesh(mesh):
            out[f"{name}_auto_tokens"], out[f"{name}_auto_logits"] = generate(
                ServingEngine(cfg, placed, scfg, mesh=mesh), prompts, n, fe)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    d = pathlib.Path(argv[0])
    cases = json.loads(argv[1])
    inp = dict(np.load(d / "inputs.npz"))
    out: dict = {}
    for name, case in cases.items():
        run(inp, name, case, out)
    np.savez(d / f"jax_serve_{next(iter(cases))}.npz", **out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
