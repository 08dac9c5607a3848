"""Exposition glue: Chrome trace-event JSON for span trees, merged metric
snapshots for the METRICS_snapshot.json artifact.

The trace format is the Trace Event Format's complete events (``"ph": "X"``
with microsecond ``ts``/``dur``), which both ``chrome://tracing`` and
perfetto (ui.perfetto.dev) load directly. Each trace tree becomes one
``tid`` lane so concurrent queries render side by side; span attributes
land in ``args``.

The port's own copy of ``repro/obs/export.py`` (stdlib only), under the same
``allanpoe_*`` names (DESIGN.md §12).
"""

from __future__ import annotations

import json
import pathlib
from typing import Iterable, Optional, Union

from repro_torch.obs.metrics import MetricsRegistry, merged_snapshot
from repro_torch.obs.tracer import Span, TraceContext, Tracer


def _events_of(span: Span, epoch: float, pid: int, tid: int, out: list) -> None:
    t1 = span.t1 if span.t1 is not None else span.t0
    out.append({
        "name": span.name,
        "ph": "X",
        "cat": "query",
        "ts": max((span.t0 - epoch) * 1e6, 0.0),
        "dur": max((t1 - span.t0) * 1e6, 0.0),
        "pid": pid,
        "tid": tid,
        "args": {k: _jsonable(v) for k, v in span.attrs.items()},
    })
    for child in list(span.children):
        _events_of(child, epoch, pid, tid, out)


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    return str(v)


def chrome_trace(
    traces: Iterable[TraceContext], epoch: float = 0.0, pid: int = 0
) -> dict:
    """Trace-event JSON dict over the given trace trees (one tid lane per
    trace, labeled with the trace name)."""
    events: list[dict] = []
    meta: list[dict] = []
    for ctx in traces:
        tid = ctx.trace_id
        meta.append({
            "name": "thread_name",
            "ph": "M",
            "pid": pid,
            "tid": tid,
            "args": {"name": f"{ctx.name}#{tid}"},
        })
        for span in [ctx.root]:
            _events_of(span, epoch, pid, tid, events)
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


def write_chrome_trace(
    path, traces: Union[Tracer, Iterable[TraceContext]]
) -> dict:
    """Write a perfetto-loadable trace file; returns the trace dict."""
    if isinstance(traces, Tracer):
        doc = chrome_trace(traces.finished, epoch=traces.epoch)
    else:
        traces = list(traces)
        epoch = min((c.root.t0 for c in traces), default=0.0)
        doc = chrome_trace(traces, epoch=epoch)
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(doc, indent=1) + "\n")
    return doc


def write_metrics_snapshot(
    path, *registries: MetricsRegistry, extra: Optional[dict] = None
) -> dict:
    """Merged JSON snapshot of several registries (service + GLOBAL is the
    usual pair) — the METRICS_snapshot.json CI artifact. ``extra`` merges
    top-level context keys (bench config, backend)."""
    doc = merged_snapshot(*registries)
    if extra:
        doc = {**extra, **doc}
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    tmp = p.with_suffix(p.suffix + ".tmp")
    tmp.write_text(json.dumps(doc, indent=2) + "\n")
    tmp.replace(p)
    return doc
