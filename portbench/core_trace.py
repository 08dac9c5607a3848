"""The program's own spans and counters on the card, over one cell's traffic.

    python3 portbench/core_trace.py --cell nq.batch-search --seed <n> [--repeats 10]
    python3 portbench/core_trace.py --cell msmarco.seal --seed <n> [--repeats 3]

Sets the cell up as a benchmark run does (``setup``), then, in this order:

- before any profiler has run in the process, alternates untraced and
  traced calls (seal: builds), each synchronised, ``--repeats`` of each:
  both sides' host seconds and the spans a traced call records, which is
  what the program's tracing costs when on;
- runs one call with the program's tracing on under ``torch.profiler``
  (CUDA activity only), the process's first profile, as in a traced
  benchmark run (the seal: build 1 with its stage clock, as such a run
  builds it); puts the spans on the profiler's clock by the context's time
  pair, and gives per span name its count, host seconds, device-busy
  seconds and the device operations that start inside it; the device's
  idle gaps by the innermost span open where each begins; the counters;
- counts the device operations of one untraced call under the same
  profile;
- times ``--repeats`` untraced calls again, after the profiler.

A program without the tracer (``obs.tracing``) gets the untraced seconds
and the device operations alone. To compare two checkouts, run the script
in each. The report goes to ``--out`` as JSON; the last line of standard
output is its summary.
"""

from __future__ import annotations

import argparse
import bisect
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
DEVICE = "cuda"


def _device_ops(prof) -> list:
    """(start ns, end ns, name) of each device operation, CLOCK_REALTIME."""
    import torch

    base = prof.profiler.kineto_results.trace_start_ns()
    dev = torch.autograd.DeviceType.CUDA
    return sorted((base + round(e.time_range.start * 1e3), base + round(e.time_range.end * 1e3),
                   e.name) for e in prof.events() if e.device_type == dev)


def _profiled(fn) -> list:
    """The device operations of ``fn()`` under a CUDA-activity profile."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return _device_ops(prof)


def analyse(ctx, ops) -> dict:
    """Spans of ``ctx`` against the device operations ``ops``."""
    from portbench.spans import covered, innermost, merged

    spans = sorted((ctx.unix_ns(s.t0), ctx.unix_ns(s.t1), s.name)
                   for s in ctx.spans()[1:])  # (t0 ns, t1 ns, name), the root left out
    busy = merged((a, b) for a, b, _ in ops)
    starts = [o[0] for o in ops]
    by_name: dict = {}
    for a, b, name in spans:
        row = by_name.setdefault(name, {"count": 0, "host_s": 0.0, "busy_s": 0.0, "ops": 0})
        row["count"] += 1
        row["host_s"] += (b - a) / 1e9
        row["busy_s"] += covered(busy, a, b) / 1e9
        row["ops"] += bisect.bisect_left(starts, b) - bisect.bisect_left(starts, a)
    for row in by_name.values():
        row["idle_pct"] = 100.0 * (1 - row["busy_s"] / row["host_s"]) if row["host_s"] else None
    idle: dict = {}
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        label = innermost(spans, e0)
        idle[label] = idle.get(label, 0) + (s1 - e0)
    return {"spans": len(spans), "by_name": by_name,
            "idle_s": {k: v / 1e9 for k, v in sorted(idle.items(), key=lambda kv: -kv[1])},
            "idle_total_s": sum(idle.values()) / 1e9,
            "window_s": (busy[-1][1] - busy[0][0]) / 1e9 if busy else 0.0,
            "busy_s": sum(b - a for a, b in busy) / 1e9, "device_ops": len(ops),
            "counters": dict(ctx.counters)}


def derived(traced: dict) -> dict:
    """The per-layer quantities the spans and counters give: per span name
    of the search rounds and build stages, mean host ms, idle share and
    device operations started per span; the share of fresh candidates."""
    out = {}
    for name, row in traced["by_name"].items():
        if name.startswith(("search.round", "build.")) and name.count(".") <= 2:
            out[name] = {"mean_ms": 1e3 * row["host_s"] / row["count"], "count": row["count"],
                         "idle_pct": row["idle_pct"], "ops_per_span": row["ops"] / row["count"]}
    c = traced["counters"]
    if c.get("search.edge_slots"):
        out["search.fresh_share"] = c["search.fresh_candidates"] / c["search.edge_slots"]
    return out


def _timed(fn, j: int) -> float:
    t0 = time.perf_counter()
    fn(j)
    return time.perf_counter() - t0


def _quartiles(v: list) -> list:
    return statistics.quantiles(v, n=4) if len(v) > 1 else [v[0]] * 3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cell", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--repeats", type=int, default=10)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch

    from portbench import harness
    from repro_torch import obs

    harness.cache_dirs(ROOT)
    if DEVICE == "cuda" and not torch.cuda.is_available():
        print("core_trace: needs a CUDA card", file=sys.stderr)
        return 2
    wl = harness.workload(args.cell)
    kind = wl["traffic"]["kind"]
    mod = harness.traffic(kind)
    ctx = harness.Ctx(args.cell, args.seed, DEVICE, harness.configuration(wl["config"]), wl,
                      False)
    state = mod.setup(ctx)
    torch.cuda.synchronize()
    stage_report: dict = {}

    def run(i: int = 0, report: dict | None = None):
        if kind == "seal":
            return mod._build(state, ctx, i, report)
        from repro_torch.core.search import search

        res = search(state.index, state.queries, state.specs[i % len(state.specs)],
                     state.params, device=DEVICE)
        torch.cuda.synchronize()
        return res

    tracer = hasattr(obs, "tracing")
    spans_per_call = []

    def traced(i: int):
        with obs.tracing(obs.TraceContext("call")) as c:
            run(i)
        spans_per_call.append(len(c.spans()) - 1)

    report = {"cell": args.cell, "seed": args.seed, "tracer": tracer,
              "device": torch.cuda.get_device_name(0) if DEVICE == "cuda" else DEVICE}
    run()
    off, on = [], []
    for j in range(args.repeats):  # both of a pair on the same input
        for side in ((j % 2, 1 - j % 2) if tracer else (0,)):
            (on if side else off).append(_timed(traced if side else run, j))
    if tracer:
        c = obs.TraceContext("call")
        with obs.tracing(c):
            ops = _profiled(lambda: run(1, stage_report if kind == "seal" else None))
        report["traced"] = analyse(c, ops)
        report["derived"] = derived(report["traced"])
        report["stage_seconds"] = stage_report.get("stage_seconds")
    report["untraced_device_ops"] = len(_profiled(run))
    after = [_timed(run, j) for j in range(args.repeats)]
    report["cost"] = {"off_s": off, "on_s": on, "after_profile_s": after,
                      "off_quartiles": _quartiles(off), "after_profile_quartiles": _quartiles(after),
                      "on_quartiles": _quartiles(on) if on else None,
                      "paired_on_minus_off_s": statistics.median(
                          b - a for a, b in zip(off, on)) if on else None,
                      "spans_per_call": spans_per_call}
    text = json.dumps(report, indent=1, default=float)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    summary = {k: report[k] for k in ("cell", "tracer", "untraced_device_ops")}
    summary.update({k: report["cost"][k][1] for k in ("off_quartiles", "after_profile_quartiles")})
    if tracer:
        summary.update(on_median_s=report["cost"]["on_quartiles"][1],
                       paired_on_minus_off_s=report["cost"]["paired_on_minus_off_s"],
                       spans=spans_per_call[0], stage_seconds=report["stage_seconds"],
                       derived=report["derived"],
                       idle=dict(list(report["traced"]["idle_s"].items())[:10]))
    print(json.dumps(summary, default=float))
    return 0


if __name__ == "__main__":
    sys.exit(main())
