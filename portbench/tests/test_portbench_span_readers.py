"""The readers of the build stages' seconds and of the device's idle share
inside a stage, on records whose spans and device operations overlap by
known amounts."""

from __future__ import annotations

import pytest

from portbench import harness
from portbench.trace import DeviceSlice, Kernel, Record


def _read(name, rec):
    return harness.metric_reader(name)(rec)


def _traced_build(offset: float) -> Record:
    """Spans on the host clock; device operations ``offset`` seconds later
    on the profiler's. Refinement [10, 14): busy 1 of 4 s; prune [14, 24):
    busy 2 of 10 s (two overlapping operations and one across its end)."""
    rec = Record()
    rec.spans = [("build.descent", 8.0, 10.0, {}), ("build.refinement", 10.0, 14.0, {}),
                 ("build.prune", 14.0, 24.0, {}),
                 # another build's prune, before the device trace began
                 ("build.prune", 1.0, 2.0, {})]
    ops = [(9.0, 10.5), (12.0, 12.5), (15.0, 16.0), (15.5, 16.5), (23.5, 25.0)]
    kernels = [Kernel("k", a + offset, b + offset) for a, b in ops]
    rec.slices["device"] = DeviceSlice(kernels, window_s=17.0, busy_s=5.0, gaps=[],
                                       clock_offset=offset)
    return rec


@pytest.mark.parametrize("offset", [0.0, 1.7e9], ids=["same-clock", "realtime-clock"])
def test_idle_share_inside_a_stage(offset):
    rec = _traced_build(offset)
    assert _read("idle_pct.refinement", rec) == pytest.approx(75.0)
    assert _read("idle_pct.prune", rec) == pytest.approx(80.0)


def test_idle_readers_find_nothing_without_a_trace_or_a_span():
    rec = _traced_build(0.0)
    rec.spans = [s for s in rec.spans if s[0] != "build.refinement"]
    assert _read("idle_pct.refinement", rec) is None
    assert _read("idle_pct.prune", Record(spans=rec.spans)) is None
    rec.slices["device"].kernels = []
    assert _read("idle_pct.prune", rec) is None


def test_refinement_seconds():
    rec = Record()
    rec.values["build.stage_seconds"] = [{"descent": 2.0, "refinement": 1.0, "prune": 3.0},
                                         {"descent": 4.0, "refinement": 2.0, "prune": 5.0}]
    assert _read("build.refinement_s", rec) == 1.5
    assert _read("build.refinement_s", Record()) is None


def test_shared_span_helpers():
    from portbench.spans import covered, innermost, merged

    busy = merged([(5, 7), (0, 2), (1, 3), (9, 12)])
    assert busy == [[0, 3], [5, 7], [9, 12]]
    assert covered(busy, 2, 10) == 1 + 2 + 1
    assert covered(busy, 3, 5) == 0 and covered(busy, 20, 30) == 0
    spans = sorted([(0, 10, "outer"), (2, 4, "a"), (5, 9, "b"), (6, 7, "b.inner")])
    assert [innermost(spans, t) for t in (1, 3, 4.5, 6.5, 8, 11)] == \
        ["outer", "a", "outer", "b.inner", "b", "outside the program"]
