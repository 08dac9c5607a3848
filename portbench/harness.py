"""Runs one cell once: set-up, the measured window, the check, the result.

Everything is found by name. ``BENCHMARK.json`` lists the cells and
metrics; ``portbench/workloads/<cell>.json`` names a cell's configuration,
its traffic kind with that kind's parameters, and the limit of each number
that ``correct`` compares; ``portbench/configs/<config>.json`` holds a
configuration; ``portbench/traffic/<kind>.py`` runs a traffic kind;
``portbench/metrics/<metric>.py`` reads one per-layer metric from a traced
run's record. A new cell, configuration, traffic kind or metric is a new
file and a new entry in ``BENCHMARK.json``.

A traffic module provides ``setup(ctx) -> state``, ``window(state, ctx,
seconds) -> dict`` (``attempted``, ``failed`` and the end-to-end values it
measured) and ``check(state, ctx) -> (checks, values)``: the numbers compared
with the cell's limits, and end-to-end values worked out by the reference
(``recall_at_10``). ``check`` runs after the window, once the program's
state is freed.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "portbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # top-level module names, compared whole


class Refused(Exception):
    """A run that must end without a result line."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    path = ROOT / "BENCHMARK.json"
    if not path.exists():
        raise Refused(f"{path} is missing")
    return load_json(path)


def workload(name: str) -> dict:
    return load_json(HERE / "workloads" / f"{name}.json")


def configuration(name: str) -> dict:
    return load_json(HERE / "configs" / f"{name}.json")


def traffic(kind: str):
    return importlib.import_module(f"portbench.traffic.{kind}")


def metric_reader(name: str):
    """The ``read(record)`` function of ``portbench/metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("portbench_metric_" + name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one the port may not load."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def process_age_s() -> float:
    """Seconds since this process started (its start time in /proc)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start


@dataclasses.dataclass
class Ctx:
    cell: str
    seed: int
    device: str
    config: dict
    workload: dict
    trace: bool
    record: object = None  # trace.Record when tracing
    control: str | None = None  # a lower-precision store in the program's place

    @property
    def params(self) -> dict:
        return self.workload["traffic"]


def cache_dirs(root: Path) -> None:
    """Fixed cache directories inside the checkout for every compiler the
    program may use (its own kernel build lives in ``build/`` already)."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(root / "build" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(root / "build" / "torch_extensions"))
    os.environ["USE_FLAX"] = "0"


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             bench: dict | None = None, control: str | None = None) -> dict:
    """One run of ``cell``: the result object of the contract, ending with
    ``checks`` ({name: {value, limit}}). ``control`` puts the reference at a
    lower precision in the program's place for the check (never in a
    benchmark run), so that ``correct`` judges the control's answers. Raises
    ``Refused`` where no result may be printed."""
    import torch

    from portbench import trace as tr

    bench = bench if bench is not None else benchmark()
    wl = workload(cell)
    cfg = configuration(wl["config"])
    mod = traffic(wl["traffic"]["kind"])
    ctx = Ctx(cell, seed, device, cfg, wl, trace, tr.Record() if trace else None, control)
    on_card = device == "cuda"

    state = mod.setup(ctx)
    if on_card:
        torch.cuda.synchronize()
    setup_s = process_age_s()
    out = mod.window(state, ctx, seconds)
    if on_card:
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    checks, values = mod.check(state, ctx)
    measured = dict(out.get("values", {}), **values, setup_s=setup_s)

    limits = wl["limits"]
    if set(checks) != set(limits):
        raise Refused(f"checks {sorted(checks)} do not match the limits {sorted(limits)}")
    compared = {k: (float(checks[k]), float(limits[k])) for k in sorted(limits)}
    correct = all(v <= lim for v, lim in compared.values()) and out["failed"] == 0

    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    metrics = {}
    if trace:
        for m in bench["per_layer"]:
            if applies(m, cell):
                v = metric_reader(m["name"])(ctx.record)
                if v is not None:
                    metrics[m["name"]] = {"value": float(v), "unit": units[m["name"]]}
    else:
        for m in bench["end_to_end"]:
            if applies(m, cell):
                if m["name"] not in measured:
                    raise Refused(f"{cell} measured no {m['name']}")
                metrics[m["name"]] = {"value": float(measured[m["name"]]), "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else device,
           "kind": torch.cuda.get_device_name(0) if on_card else device,
           "count": int(wl["chips"]), "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics, "device": dev}
    if trace:
        main = ctx.record.slices.get("device")
        if main is not None:
            dev["busy_s"], dev["window_s"] = main.busy_s, main.window_s
        named = ctx.record.slices.get("labelled", main)
        if main is not None:
            result["breakdown"] = {"device_ops": tr.breakdown(main)["device_ops"],
                                   "idle_gaps": tr.breakdown(named)["idle_gaps"]}
    # the check runs program code too (the seal's searches), so look last
    found = forbidden_modules()
    if found:
        raise Refused("modules the port may not load are loaded: " + ", ".join(found))
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in compared.items()}
    return result


def emit(result: dict) -> None:
    """The numbers compared beside their limits as the last lines of
    standard error, then the result as the last line of standard output."""
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
