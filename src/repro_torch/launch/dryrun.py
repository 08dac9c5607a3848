"""Dry run of the port (``repro/launch/dryrun.py``): every (architecture x
input shape x mesh) cell's per-device program evaluated on ``meta``
tensors over a dry production mesh (``launch.mesh.make_production_mesh(...,
dry=True)``: a fake process group of 256 or 512 ranks, this process rank
0), so nothing is allocated and nothing computes. Each cell reports memory,
cost (``launch.cost_analysis``) and collective traffic per device, and the
roofline on H100 constants.

    python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k --mesh multi
    python -m repro_torch.launch.dryrun --all --out build/dryrun   # a process per cell

Rank 0's program is ``repro``'s per-device program: train (loss, gradients
and AdamW over the placed state, ``training.train_loop.make_train_step``),
prefill and decode (``models.transformer`` on a placed model, the cache
split by ``cache_specs``, as ``ServingEngine(mesh=)`` runs them). Memory is
computed from the specs: ``argument_size_in_bytes`` is what the rank holds
for the program, its blocks of every parameter, the optimizer state, the
batch and the cache (and decode's int32 position): the footprint a
capacity decision reads, since an eager rank keeps every block in memory.
``read_argument_bytes`` is the part of it the program reads, without the
parameters a cell never touches (the MTP head outside training; in decode
the audio encoder and the cross attentions' key and value projections,
whose keys and values come from the cache): XLA drops such arguments, so
this is the number ``repro``'s ``memory_analysis`` reports.
``output_size_in_bytes`` is the blocks of what the program returns (the
train state and its metrics; the logits and the cache). XLA's
``temp_size_in_bytes`` and ``generated_code_size_in_bytes`` have no
counterpart in an eager program and are left out. The counts replace
``repro``'s ``hlo`` record (``counts``); its ``compile_s`` is ``trace_s``,
the seconds of the meta run.

The ``allanpoe-retrieval`` cell reports the rank's bytes only: the index
block and the queries of ``repro``'s ``build_retrieval_program`` shapes
(paper Table 1). The port's distributed search decides its rounds on the
host (``core/distributed.py``: the round loop reads device values), which a
meta tensor does not have, so it gives no counts.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import re
import subprocess
import sys
import time

import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.launch.cost_analysis import analyze, roofline_terms
from repro_torch.models import transformer as tfm
from repro_torch.models.attention import TensorSpec
from repro_torch.models.config import SHAPES, ModelConfig
from repro_torch.models.layers import dtype_of

RETRIEVAL_ARCH = "allanpoe-retrieval"  # extra dry-run target: the paper's index
DEFAULT_OUT = "build/dryrun"  # gitignored


def batch_split(batch: int, mesh) -> bool:
    """Whether the data-parallel axes split a batch of ``batch`` rows
    (``repro``'s ``batch_size_spec`` and ``cache_specs``' rule)."""
    from repro_torch.launch.mesh import mesh_dp_size

    dp = mesh_dp_size(mesh)
    return batch % dp == 0 and batch >= dp


def input_specs(cfg: ModelConfig, shape_name: str, mesh=None) -> dict:
    """Shape and dtype stand-ins (whole) for every model input of a cell."""
    shape = SHAPES[shape_name]
    b, l = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        out = {"tokens": TensorSpec((b, l), torch.int32)}
        if cfg.family in ("vlm", "audio"):
            out["frontend"] = TensorSpec((b, cfg.n_frontend_tokens, cfg.d_model), dtype_of(cfg))
        return out
    return {"token": TensorSpec((b,), torch.int32), "cache": tfm.cache_shape(cfg, b, l),
            "pos": TensorSpec((), torch.int32)}


def _meta(spec: TensorSpec) -> torch.Tensor:
    return torch.empty(spec.shape, dtype=spec.dtype, device="meta")


def _nbytes(tree) -> int:
    """Bytes of the tensors of a tree of dicts, lists and tuples, a module's
    parameters among them."""
    if isinstance(tree, torch.nn.Module):
        return sum(p.numel() * p.element_size() for p in tree.parameters())
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_nbytes(v) for v in tree)
    return 0


def _unread(cfg: ModelConfig, kind: str, name: str) -> bool:
    """Whether a cell's program never reads parameter ``name``: the MTP
    head outside training; in decode the audio encoder, and the cross
    attentions' key and value projections (their keys and values come from
    the cache). XLA drops such arguments, so ``repro``'s memory analysis
    holds no buffer for them."""
    if kind != "train" and name.startswith("mtp."):
        return True
    if kind != "decode":
        return False
    if cfg.family == "audio" and name.startswith(("encoder.", "enc_norm.")):
        return True
    return re.search(r"\.cross\.(attn\.)?(wk|wv|bk|bv)$", name) is not None


@dataclasses.dataclass
class CellProgram:
    """A cell's rank-0 program: ``run()`` evaluates it on meta tensors and
    returns its outputs; ``arguments`` are the rank's blocks of its inputs,
    ``read`` those of them the program reads."""

    run: object
    arguments: dict
    read: dict

    def argument_bytes(self) -> int:
        return _nbytes(self.arguments)

    def read_bytes(self) -> int:
        return _nbytes(self.read)


def build_cell_program(cfg: ModelConfig, shape_name: str, mesh) -> CellProgram:
    """The rank's program of a train, prefill or decode cell on the dry
    ``mesh``, its state and inputs placed as the specs say."""
    from repro_torch.launch.sharding import block_of, dp_block, place_model
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_loop import (
        TrainConfig,
        dp_axes_of,
        make_train_step,
        mesh_model,
        mesh_sharding,
    )

    shape = SHAPES[shape_name]
    sharding = mesh_sharding(cfg, mesh)
    params = place_model(tfm.Transformer(cfg, torch.device("meta")), sharding)
    ins = {k: (v if k == "cache" else _meta(v)) for k, v in input_specs(cfg, shape_name).items()}
    split = batch_split(shape.global_batch, mesh)
    rows = (lambda t: dp_block(t, mesh, dp_axes_of(mesh))) if split else (lambda t: t)
    if shape.kind == "train":
        ocfg = opt.OptConfig(moment_dtype="bfloat16" if cfg.n_params > 100e9 else "float32")
        state = {"params": params, "opt": opt.init_opt_state(dict(params.named_parameters()),
                                                            ocfg)}
        step = make_train_step(cfg, TrainConfig(opt=ocfg), mesh, sharding.specs)
        batch = {k: ins[k] for k in ("tokens", "frontend") if k in ins}
        held = {"state": state, "batch": {k: rows(t) for k, t in batch.items()}}
        return CellProgram(lambda: step(state, batch), held, held)
    specs = tfm.mesh_cache_specs(cfg, mesh, shape.global_batch, shape.seq_len)
    context = lambda: mesh_model(params, mesh, global_dp=split, cache_specs=specs)  # noqa: E731
    if shape.kind == "prefill":
        prefill = tfm.make_prefill(cfg, shape.seq_len)
        fe = ins.get("frontend")

        def run():
            with context():
                return prefill(params, rows(ins["tokens"]), None if fe is None else rows(fe))

        inputs = {"tokens": rows(ins["tokens"]), **({} if fe is None else {"frontend": rows(fe)})}
        return CellProgram(run, {"params": params, **inputs},
                           {"params": _read(params, cfg, "prefill"), **inputs})
    cache = {g: {k: block_of(_meta(s), specs[g][k], mesh) for k, s in tree.items()}
             for g, tree in ins["cache"].items()}
    decode = tfm.make_decode_step(cfg)

    def run_decode():
        with context():
            return decode(params, rows(ins["token"]), cache, 0)

    inputs = {"token": rows(ins["token"]), "cache": cache}
    return CellProgram(run_decode, {"params": params, **inputs, "pos": ins["pos"]}, {
        "params": _read(params, cfg, "decode"), **inputs,
        # rwkv6's decode never reads the position (XLA drops the argument)
        **({} if cfg.family == "ssm" else {"pos": ins["pos"]})})


def _read(params, cfg: ModelConfig, kind: str) -> dict:
    """{name: parameter block} of those a cell's program reads."""
    return {n: p for n, p in params.named_parameters() if not _unread(cfg, kind, n)}


def retrieval_bytes(mesh, overrides: dict | None = None) -> dict:
    """The rank's argument bytes of ``repro``'s ``build_retrieval_program``
    cell: its segment of a 1M-doc index (paper Table 1's shapes) and the
    queries."""
    from repro_torch.launch.mesh import mesh_dp_size

    ov = overrides or {}
    n_seg = mesh_dp_size(mesh)
    n_loc = 1_048_576 // n_seg
    d, ps, pf = 1024, 64, 32
    deg, dk, lcap, ed = 32, 8, 4, 4
    n_q = int(ov.get("n_queries", 1024))
    f = 2 if ov.get("bf16") else 4

    def fused(n):  # dense, learned and lexical (ids int32, values)
        return n * (d * f + ps * (4 + f) + pf * (4 + f))

    index = (fused(n_loc) + n_loc * 4 * (deg + dk + lcap * 4 + ed) + 64 * 4 * 4 + 64 * 64
             + 16 * 4 + n_loc + n_loc * f + n_loc * 4)  # ..., alive, self_ip, global ids
    return {"argument_size_in_bytes": index + fused(n_q), "index_bytes": index,
            "query_bytes": fused(n_q)}


def _parse_overrides(spec: str | None) -> dict:
    """--set a=1,b=flash,c=true -> config overrides."""
    out = {}
    if not spec:
        return out
    for kv in spec.split(","):
        k, v = kv.split("=")
        if v.lower() in ("true", "false"):
            out[k] = v.lower() == "true"
        else:
            try:
                out[k] = int(v)
            except ValueError:
                try:
                    out[k] = float(v)
                except ValueError:
                    out[k] = v
    return out


def evaluate_cell(cfg: ModelConfig, shape_name: str, mesh) -> dict:
    """Memory, counts, model flops and roofline of one cell on ``mesh``
    (``repro``'s ``run_cell`` after its compile)."""
    from repro_torch.launch.mesh import axis_sizes

    n_devices = 1
    for s in axis_sizes(mesh).values():
        n_devices *= s
    t0 = time.time()
    prog = build_cell_program(cfg, shape_name, mesh)
    memory = {"argument_size_in_bytes": prog.argument_bytes(),
              "read_argument_bytes": prog.read_bytes()}
    out, counts = analyze(prog.run)
    memory["output_size_in_bytes"] = _nbytes(out)
    record = {"trace_s": round(time.time() - t0, 2), "n_devices": n_devices, "memory": memory,
              "counts": counts}
    shape = SHAPES[shape_name]
    n_tokens = shape.global_batch * (shape.seq_len if shape.kind in ("train", "prefill") else 1)
    record["model_flops"] = float((6 if shape.kind == "train" else 2) * cfg.n_active_params
                                  * n_tokens)
    record["model_flops_per_device"] = record["model_flops"] / n_devices
    record["n_params"] = float(cfg.n_params)
    record["n_active_params"] = float(cfg.n_active_params)
    if counts["dot_flops"] > 0:
        record["useful_flops_ratio"] = record["model_flops_per_device"] / counts["dot_flops"]
    record["roofline"] = roofline_terms(hlo_flops=counts["dot_flops"],
                                        hlo_bytes=counts["hbm_bytes"],
                                        coll_bytes_per_device=counts["collective_bytes"],
                                        n_chips=n_devices)
    return record


def run_cell(arch: str, shape_name: str, multi_pod: bool, overrides: str | None = None) -> dict:
    from repro_torch.launch.mesh import make_production_mesh

    mesh = make_production_mesh(multi_pod=multi_pod, device_type="meta", dry=True)
    record = {"arch": arch, "shape": shape_name, "mesh": "2x16x16" if multi_pod else "16x16",
              "n_devices": 512 if multi_pod else 256, "overrides": overrides or ""}
    if arch == RETRIEVAL_ARCH:
        record["memory"] = retrieval_bytes(mesh, _parse_overrides(overrides))
        record["status"] = "OK(bytes only: the search's rounds read device values)"
        return record
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **_parse_overrides(overrides))
    if shape_name == "long_500k" and not cfg.supports_long_context:
        record["status"] = "SKIP(full-attn)"
        return record
    record.update(evaluate_cell(cfg, shape_name, mesh))
    c = record["counts"]
    print("memory:", record["memory"])
    print("per device: dot_flops=%.3e hbm_bytes=%.3e coll_bytes=%.3e %s"
          % (c["dot_flops"], c["hbm_bytes"], c["collective_bytes"], c["collective_counts"]))
    print("roofline:", {k: (round(v, 4) if isinstance(v, float) else v)
                        for k, v in record["roofline"].items()})
    record["status"] = "OK"
    return record


def orchestrate(out_dir: str, jobs: int, meshes: list[str], archs: list[str], shapes: list[str]):
    """Every cell in a process of its own (each opens its own fake world),
    ``jobs`` at a time; ``summary.json`` beside the cells' records."""
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    cells = [(arch, "search_1m" if arch == RETRIEVAL_ARCH else shape, mesh)
             for mesh in meshes for arch in archs
             for shape in ([None] if arch == RETRIEVAL_ARCH else shapes)]
    procs, results = [], []

    def drain(block: bool = False):
        for item in list(procs):
            p, cell, path, log = item
            if p.poll() is None and not block:
                continue
            p.wait()
            procs.remove(item)
            if path.exists():
                results.append(json.loads(path.read_text()))
                r = results[-1]
                print(f"[{len(results)}/{len(cells)}] {r['arch']} {r['shape']} {r['mesh']}: "
                      f"{r.get('status')} ({r.get('trace_s', '-')}s)", flush=True)
            else:
                print(f"FAILED: {cell}; see {log}", flush=True)
                results.append({"arch": cell[0], "shape": cell[1], "mesh": cell[2],
                                "status": "FAIL", "log": str(log)})

    for arch, shape, mesh in cells:
        path = out / f"{arch}__{shape}__{mesh}.json"
        if path.exists():
            results.append(json.loads(path.read_text()))
            continue
        log = out / f"{arch}__{shape}__{mesh}.log"
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape",
               shape, "--mesh", mesh, "--json-out", str(path)]
        with open(log, "w") as lf:
            procs.append((subprocess.Popen(cmd, stdout=lf, stderr=lf), (arch, shape, mesh),
                          path, log))
        while len(procs) >= jobs:
            drain()
            time.sleep(0.5)
    while procs:
        drain(block=True)
    (out / "summary.json").write_text(json.dumps(results, indent=1))
    n_ok = sum(1 for r in results if str(r.get("status", "")).startswith("OK"))
    n_skip = sum(1 for r in results if str(r.get("status", "")).startswith("SKIP"))
    print(f"\n{n_ok} OK, {n_skip} skipped, {len(results) - n_ok - n_skip} failed of "
          f"{len(results)} cells")
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--mesh", default="multi", choices=["single", "multi"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--jobs", type=int, default=1)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--set", dest="overrides", default=None,
                    help="config overrides, e.g. attn_impl=flash,remat=dots")
    ap.add_argument("--archs", default=None, help="comma list (with --all)")
    ap.add_argument("--shapes", default=None, help="comma list (with --all)")
    args = ap.parse_args(argv)
    if args.all:
        archs = args.archs.split(",") if args.archs else list_archs() + [RETRIEVAL_ARCH]
        shapes = args.shapes.split(",") if args.shapes else list(SHAPES)
        orchestrate(args.out, args.jobs, ["single", "multi"], archs, shapes)
        return 0
    if args.arch is None:
        ap.error("--arch (or --all) is required")
    record = run_cell(args.arch, args.shape, args.mesh == "multi", args.overrides)
    print(json.dumps({k: v for k, v in record.items() if k != "counts"}, indent=1))
    if args.json_out:
        pathlib.Path(args.json_out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.json_out).write_text(json.dumps(record, indent=1))
    return 0 if str(record.get("status", "")).startswith(("OK", "SKIP")) else 1


if __name__ == "__main__":
    sys.exit(main())
