"""Shared set-up of the benchmark's CPU tests: the repository root and the
port's sources on the path, and the cells cut to a size the CPU runs in
seconds (``tiny``)."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_CONFIG = dict(n_docs=512, n_queries=24, n_topics=8, d_dense=32)
TINY_TRAFFIC = {
    "batch_search": dict(check_span=2),
    "seal": dict(check_queries=16, segment_docs=128, slices=2, knn_sample=16),
}
SEED = 2**31 + 12345  # beyond 32 signed bits, as a run's seed may be


@pytest.fixture
def tiny(monkeypatch):
    """The harness, finding every cell and configuration cut to the tiny
    size; returns the harness module."""
    from portbench import harness
    from portbench import reference

    # several chunks per pass, as at full size
    monkeypatch.setattr(reference, "_DOC_CHUNK", 96)
    monkeypatch.setattr(reference, "_ROW_CHUNK", 16)

    configuration, workload = harness.configuration, harness.workload

    def small_config(name):
        return dict(configuration(name), **TINY_CONFIG)

    def small_workload(name):
        w = workload(name)
        w["traffic"].update(TINY_TRAFFIC.get(w["traffic"]["kind"], {}))
        return w

    monkeypatch.setattr(harness, "configuration", small_config)
    monkeypatch.setattr(harness, "workload", small_workload)
    return harness
