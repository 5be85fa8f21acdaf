"""Fault-tolerant step runner: checkpoint/restart, bounded retries,
failure injection, straggler accounting (counterpart of
``repro/runtime/ft.py``).

Synchronous data-parallel training sees a node failure as a failed or hung
step on every rank; the recovery protocol is (1) abort the step, (2) rebuild
the device group (``runtime/elastic.py`` of the reference; waits for the mesh
slice here), (3) restore the last committed checkpoint, (4) resume from the
data pipeline's step counter (deterministic batches make this replay exact).

Straggler mitigation: with synchronous collectives a straggler is invisible
inside a step; the lever is *between* steps.  The runner keeps an EWMA of
step wall-time; a step exceeding ``straggler_factor``× the EWMA is logged and
counted, and after ``straggler_patience`` consecutive slow steps the runner
invokes ``on_straggler`` (production: re-shard data away from the slow host /
request node replacement; here: a hook).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

from ..checkpoint import CheckpointManager


class StepFailure(RuntimeError):
    pass


@dataclasses.dataclass
class FTConfig:
    max_failures: int = 3
    checkpoint_every: int = 50
    straggler_factor: float = 2.5
    straggler_patience: int = 3
    ewma: float = 0.9


@dataclasses.dataclass
class RunStats:
    steps: int = 0
    failures: int = 0
    restores: int = 0
    stragglers: int = 0
    straggler_events: int = 0
    ewma_step_s: float = 0.0


class ResilientRunner:
    """Drives `state = step_fn(state, batch)` with checkpoint/restart."""

    def __init__(self, step_fn: Callable, ckpt: CheckpointManager, cfg: FTConfig,
                 on_straggler: Optional[Callable[[int], None]] = None,
                 fail_injector: Optional[Callable[[int], None]] = None):
        self.step_fn = step_fn
        self.ckpt = ckpt
        self.cfg = cfg
        self.on_straggler = on_straggler
        self.fail_injector = fail_injector
        self.stats = RunStats()
        self._slow_streak = 0

    def run(self, state, pipeline, n_steps: int, start_step: int = 0):
        """pipeline must expose batch_at(step) (deterministic replay)."""
        step = start_step
        failures = 0
        while step < n_steps:
            t0 = time.monotonic()
            try:
                if self.fail_injector is not None:
                    self.fail_injector(step)  # may raise StepFailure
                batch = pipeline.batch_at(step)
                state = self.step_fn(state, batch)
                self.stats.steps += 1
            except StepFailure:
                failures += 1
                self.stats.failures += 1
                if failures > self.cfg.max_failures:
                    raise
                # recovery protocol: restore last committed state, replay
                latest = self.ckpt.latest_step()
                if latest is not None:
                    state, step, _ = self.ckpt.restore(state, latest)
                    self.stats.restores += 1
                continue
            failures = 0
            dt = time.monotonic() - t0
            st = self.stats
            st.ewma_step_s = dt if st.ewma_step_s == 0 else (
                self.cfg.ewma * st.ewma_step_s + (1 - self.cfg.ewma) * dt)
            if st.ewma_step_s > 0 and dt > self.cfg.straggler_factor * st.ewma_step_s:
                st.stragglers += 1
                self._slow_streak += 1
                if self._slow_streak >= self.cfg.straggler_patience:
                    st.straggler_events += 1
                    self._slow_streak = 0
                    if self.on_straggler is not None:
                        self.on_straggler(step)
            else:
                self._slow_streak = 0
            step += 1
            if step % self.cfg.checkpoint_every == 0 or step == n_steps:
                self.ckpt.save(step, state)
        self.ckpt.wait()
        return state, self.stats
