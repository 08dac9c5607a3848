"""Atomic checkpoints in ``repro``'s layout (``repro/checkpoint/checkpoint.py``).

Layout:  <dir>/step_<N>/
            manifest.json           tree structure, paths, shapes, dtypes
            leaf_<i>.npy            one file per leaf
         <dir>/step_<N>.done        commit marker (atomic rename contract)

Leaves are ordered and named as ``jax.tree_util`` orders and names a tree of
dicts (keys sorted; paths like ``['opt']/['m']/['embed']/['tok']``), and
bfloat16 leaves are stored as raw uint16 bits, as ``repro`` stores them. A
port train state (``training.train_loop``) is saved as ``repro``'s state
tree (``convert.train_state_to_tree``), so a train state saved by either
package restores into the other. The tree is written to a temporary
directory, renamed into place, and only then marked ``.done``.

On a device mesh (a train state made by ``make_train_state(..., mesh=)``,
its model carrying ``placement``): ``save_checkpoint`` gathers the state
whole on every rank, rank 0 writes the files the one-device save writes, and
every rank meets at a barrier; the compressed mode's error-feedback residual,
the rank's own, is not saved (it restarts at zero). ``restore_checkpoint``
with ``shardings`` (a ``launch.sharding.StateSharding``) reads each leaf
whole and keeps this rank's block, so a checkpoint saved on one mesh shape
restores on another, or on one device, to the same logical state.
"""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import tempfile
from typing import Any, Mapping, Optional

import numpy as np
import torch

from repro_torch.convert import train_state_from_numpy, train_state_to_tree
from repro_torch.models.transformer import Transformer


def _is_train_state(tree) -> bool:
    return isinstance(tree, Mapping) and isinstance(tree.get("params"), Transformer)


def _as_tree(tree) -> Mapping:
    return train_state_to_tree(tree) if _is_train_state(tree) else tree


def _flatten(tree: Mapping, prefix: str = "") -> list[tuple[str, Any]]:
    """(path, leaf) in ``jax.tree_util`` order: dict keys sorted, depth first."""
    out = []
    for key in sorted(tree):
        path = f"{prefix}/['{key}']" if prefix else f"['{key}']"
        sub = tree[key]
        out.extend(_flatten(sub, path) if isinstance(sub, Mapping) else [(path, sub)])
    return out


def _treedef(tree: Mapping) -> str:
    def rec(t):
        return "{" + ", ".join(f"'{k}': " + (rec(t[k]) if isinstance(t[k], Mapping) else "*")
                               for k in sorted(t)) + "}"

    return f"PyTreeDef({rec(tree)})"


def _to_array(leaf) -> tuple[np.ndarray, str]:
    """(array to store, logical dtype): bfloat16 as its raw uint16 bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    if str(arr.dtype) == "bfloat16":
        return arr.view(np.uint16), "bfloat16"
    return arr, str(arr.dtype)


def _placement(tree):
    """The mesh placement of a train state's model, or None."""
    return getattr(tree["params"], "placement", None) if _is_train_state(tree) else None


def save_checkpoint(directory: str | os.PathLike, step: int, tree: Any, *, keep: int = 3,
                    extra: Optional[dict] = None):
    """Save ``tree`` (a port train state, or nested dicts of tensors, numpy
    arrays or scalars) as ``<directory>/step_<step>``; keep the last ``keep``
    committed steps. ``extra``: JSON-serializable metadata merged into the
    manifest, committed with the leaves. A train state on a mesh (see the
    module docstring) is gathered and written by rank 0."""
    sh = _placement(tree)
    if sh is not None:
        import torch.distributed as dist

        from repro_torch.launch.sharding import gather_state

        whole = gather_state({"params": tree["params"], "opt": tree["opt"]}, sh.tree_specs(),
                             sh.mesh)
        if dist.get_rank() == 0:
            save_checkpoint(directory, step, whole, keep=keep, extra=extra)
        dist.barrier()
        return
    tree = _as_tree(tree)
    save_flat(directory, step, _treedef(tree), _flatten(tree), keep=keep, extra=extra)


def save_flat(directory: str | os.PathLike, step: int, treedef: str,
              flat: list[tuple[str, Any]], *, keep: int = 3, extra: Optional[dict] = None):
    """Write (path, leaf) pairs, already in ``jax.tree_util`` order, under
    the given treedef string: the layout ``save_checkpoint`` writes, for
    trees that are not dicts (``index_io``'s indexes and pools)."""
    directory = pathlib.Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    tmp = pathlib.Path(tempfile.mkdtemp(dir=directory, prefix=".tmp_"))
    manifest = {"step": int(step), "treedef": treedef, "paths": [p for p, _ in flat],
                "leaves": []}
    if extra:
        manifest.update(extra)
    for i, (_, leaf) in enumerate(flat):
        arr, dtype = _to_array(leaf)
        np.save(tmp / f"leaf_{i}.npy", arr)
        manifest["leaves"].append({"index": i, "shape": list(arr.shape), "dtype": dtype})
    with open(tmp / "manifest.json", "w") as f:
        json.dump(manifest, f)

    final = directory / f"step_{step}"
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    # commit marker AFTER the directory rename: readers trust only .done
    (directory / f"step_{step}.done").touch()

    for s in sorted(all_steps(directory))[:-keep]:
        shutil.rmtree(directory / f"step_{s}", ignore_errors=True)
        (directory / f"step_{s}.done").unlink(missing_ok=True)


def all_steps(directory: str | os.PathLike) -> list[int]:
    out = []
    for marker in pathlib.Path(directory).glob("step_*.done"):
        try:
            out.append(int(marker.stem.split("_")[1]))
        except (IndexError, ValueError):
            continue
    return sorted(out)


def latest_step(directory: str | os.PathLike) -> Optional[int]:
    steps = all_steps(directory)
    return steps[-1] if steps else None


def load_leaf(path: pathlib.Path, meta: dict) -> torch.Tensor:
    arr = np.load(path)
    if meta["dtype"] == "bfloat16" and arr.dtype == np.uint16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _unflatten(paths: list[str], leaves: list) -> dict:
    tree: dict = {}
    for path, leaf in zip(paths, leaves):
        keys = [k[2:-2] for k in path.split("/")]
        node = tree
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = leaf
    return tree


def _logical_template(state) -> dict:
    """A train state of the whole shapes of ``state``'s model, on the meta
    device (its tree's paths and shapes, no memory)."""
    model = Transformer(state["params"].cfg, torch.device("meta"))
    dt = next(iter(state["opt"]["m"].values())).dtype
    zeros = lambda: {n: torch.empty(p.shape, dtype=dt, device="meta")
                     for n, p in model.named_parameters()}
    return {"params": model, "opt": {"m": zeros(), "v": zeros(),
                                     "step": torch.zeros((), dtype=torch.int32, device="meta")}}


def restore_checkpoint(directory: str | os.PathLike, step: int, target_tree: Any,
                       shardings=None) -> Any:
    """Restore ``step`` into the structure of ``target_tree`` (its values are
    ignored). A port train state comes back as a new train state on the
    target's device, with the target's moment dtype; nested dicts come back
    as tensors in the stored dtypes, on each target leaf's device. Raises
    ``ValueError`` when the leaves' paths or shapes differ. ``shardings``
    (default: the target model's ``placement``): the state comes back as
    this rank's blocks on that mesh."""
    sh = _placement(target_tree) if shardings is None else shardings
    template = _logical_template(target_tree) if sh is not None else target_tree
    tree = _read_tree(directory, step, template)
    if not _is_train_state(target_tree):
        return tree
    model = target_tree["params"]
    m_dtype = next(iter(target_tree["opt"]["m"].values())).dtype
    out = train_state_from_numpy(model.cfg, tree, model.device,
                                 "bfloat16" if m_dtype == torch.bfloat16 else "float32")
    if sh is None:
        return out
    from repro_torch.launch.sharding import place_state

    return place_state(out, sh)


def _read_tree(directory, step: int, target_tree) -> dict:
    """The checkpoint's tree, checked against ``target_tree``'s paths and
    shapes: float32 and int32 leaves for a train state, else the stored
    dtypes on each target leaf's device."""
    directory = pathlib.Path(directory) / f"step_{step}"
    with open(directory / "manifest.json") as f:
        manifest = json.load(f)
    state = _is_train_state(target_tree)
    flat_t = _flatten(_as_tree(target_tree))
    if len(flat_t) != len(manifest["leaves"]):
        raise ValueError(f"leaf count mismatch: ckpt {len(manifest['leaves'])} vs target "
                         f"{len(flat_t)}")
    paths = [p for p, _ in flat_t]
    if manifest.get("paths", paths) != paths:
        raise ValueError("checkpoint paths differ from the target's")
    leaves = []
    for i, (path, tgt) in enumerate(flat_t):
        t = load_leaf(directory / f"leaf_{i}.npy", manifest["leaves"][i])
        expected = tuple(np.shape(tgt))
        if tuple(t.shape) != expected:
            raise ValueError(f"leaf {i} ({path}): checkpoint shape {tuple(t.shape)} != target "
                             f"{expected}")
        if state:  # train_state_from_numpy reads float32 and int32 leaves
            leaves.append(t.float() if t.dtype == torch.bfloat16 else t)
        else:
            leaves.append(t.to(tgt.device) if isinstance(tgt, torch.Tensor) else t)
    return _unflatten(paths, leaves)
