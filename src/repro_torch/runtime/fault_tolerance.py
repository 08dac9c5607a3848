"""Fault tolerance for 1000+-node runs (the port's own copy of
``repro/runtime/fault_tolerance.py``, which imports no jax): straggler
detection, elastic mesh shapes, and a supervised step-driver with
checkpoint/restart.

On a real cluster the failure signals come from collective timeouts and the
coordinator's heartbeat service; in the tests they are injected
(`FailureInjector`). The recovery *logic* — detect, shrink the mesh, restore
the last committed checkpoint, deterministically skip data — is the same.
The restart contract needs a deterministic step: the flash backward kernels
use no atomics, so a step on the card gives the same state run to run.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Optional

import numpy as np


# ---------------------------------------------------------------------------
# straggler detection
# ---------------------------------------------------------------------------


class StragglerMonitor:
    """Moving-percentile step-time detector.

    At scale, per-host step times are all-gathered each K steps (a tiny
    collective); any host slower than `threshold` x p50 over the window is
    flagged for preemptive replacement — the standard mitigation for fail-slow
    HBM/ICI degradation."""

    def __init__(self, window: int = 32, threshold: float = 1.8):
        self.window = window
        self.threshold = threshold
        self._times: dict[int, deque] = {}

    def record(self, host_id: int, step_time_s: float):
        self._times.setdefault(host_id, deque(maxlen=self.window)).append(step_time_s)

    def p50(self) -> float:
        all_t = [t for d in self._times.values() for t in d]
        return float(np.median(all_t)) if all_t else 0.0

    def stragglers(self) -> list[int]:
        p50 = self.p50()
        if p50 <= 0:
            return []
        out = []
        for host, d in self._times.items():
            if len(d) >= max(4, self.window // 4) and float(np.median(d)) > self.threshold * p50:
                out.append(host)
        return out


# ---------------------------------------------------------------------------
# elastic mesh
# ---------------------------------------------------------------------------


def elastic_mesh_shape(
    n_devices: int, model_parallel: int, *, pod_size: Optional[int] = None
) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """Largest valid production mesh for the surviving device count.

    Keeps the model axis intact (TP cannot shrink without resharding the
    layer math) and gives the rest to (pod, data)."""
    assert n_devices % model_parallel == 0, "surviving devices must cover TP"
    rest = n_devices // model_parallel
    if pod_size and rest % pod_size == 0 and rest // pod_size > 1:
        return ((rest // pod_size, pod_size, model_parallel), ("pod", "data", "model"))
    return ((rest, model_parallel), ("data", "model"))


# ---------------------------------------------------------------------------
# supervised training driver
# ---------------------------------------------------------------------------


class FailureInjector:
    """Test hook: raise at chosen steps to simulate node loss."""

    def __init__(self, fail_at: Optional[set[int]] = None):
        self.fail_at = fail_at or set()
        self.failed: set[int] = set()

    def maybe_fail(self, step: int):
        if step in self.fail_at and step not in self.failed:
            self.failed.add(step)
            raise RuntimeError(f"injected node failure at step {step}")


@dataclasses.dataclass
class RunReport:
    steps_done: int
    restarts: int
    losses: list
    straggler_events: int


def run_supervised(
    *,
    n_steps: int,
    make_state: Callable[[], dict],
    train_step: Callable,
    batch_fn: Callable[[int], dict],
    ckpt_dir: str,
    ckpt_every: int = 10,
    max_restarts: int = 3,
    injector: Optional[FailureInjector] = None,
    monitor: Optional[StragglerMonitor] = None,
) -> RunReport:
    """Checkpoint/restart driver: crashes roll back to the last committed
    checkpoint and resume with deterministic data skip."""
    from repro_torch.checkpoint import latest_step, restore_checkpoint, save_checkpoint

    restarts = 0
    losses: list = []
    straggler_events = 0

    while True:
        state = make_state()
        start = latest_step(ckpt_dir)
        if start is not None:
            state = restore_checkpoint(ckpt_dir, start, state)
            step = start
        else:
            step = 0
        try:
            while step < n_steps:
                t0 = time.perf_counter()
                if injector is not None:
                    injector.maybe_fail(step)
                state, metrics = train_step(state, batch_fn(step))
                dt = time.perf_counter() - t0
                if monitor is not None:
                    monitor.record(0, dt)
                    if monitor.stragglers():
                        straggler_events += 1
                losses.append(float(metrics["loss"]))
                step += 1
                if step % ckpt_every == 0 or step == n_steps:
                    save_checkpoint(ckpt_dir, step, state)
            return RunReport(step, restarts, losses, straggler_events)
        except RuntimeError:
            restarts += 1
            if restarts > max_restarts:
                raise
            continue
