"""Dispatch accounting for the build path. The port's own copy of
``repro/runtime/dispatch.py`` (which imports no jax).

A "dispatch" is one call of a build program at an instrumented call site:
the unit ``repro`` counts as one jitted-executable launch. The port runs
those programs eagerly, so the counter counts the same call sites, not the
kernel launches under them (each kernel wrapper keeps its own
``.launches``). ``build_rows`` counts the corpus rows fed through graph
(re)construction: incremental compaction must grow it by O(grow segment),
a full rebuild by O(corpus).

Both counters are series in the port's process-wide metrics registry
(``repro_torch.obs.metrics.GLOBAL``), so the serving exposition and these
accessors read the same numbers.

Usage:
    with dispatch.track() as t:
        build_index(...)
    t.count  # dispatches issued inside the block
"""

from __future__ import annotations

import contextlib

from repro_torch.obs.metrics import GLOBAL as _OBS

_DISPATCHES = _OBS.counter(
    "allanpoe_runtime_dispatches_total",
    "jitted-executable launches at instrumented build-path call sites",
)
_BUILD_ROWS = _OBS.counter(
    "allanpoe_runtime_build_rows_total",
    "corpus rows fed through graph (re)construction",
)


def tick(n: int = 1) -> None:
    """Record ``n`` build-program calls (called at instrumented sites)."""
    _DISPATCHES.inc(n)


def count() -> int:
    return int(_DISPATCHES.total())


def build_rows_tick(n: int) -> None:
    """Record ``n`` corpus rows entering a graph (re)build."""
    _BUILD_ROWS.inc(int(n))


def build_rows() -> int:
    """Total corpus rows fed through graph construction so far."""
    return int(_BUILD_ROWS.total())


def reset() -> None:
    _DISPATCHES.reset()
    _BUILD_ROWS.reset()


class _Tracker:
    def __init__(self, start: int):
        self._start = start
        self._stop: int | None = None

    def freeze(self, stop: int) -> None:
        self._stop = stop

    @property
    def count(self) -> int:
        return (count() if self._stop is None else self._stop) - self._start


@contextlib.contextmanager
def track():
    """Context manager counting dispatches issued inside the block."""
    t = _Tracker(count())
    try:
        yield t
    finally:
        t.freeze(count())
