"""Straggler detection and restart policy for training.

Counterpart of ``repro/training/fault_tolerance.py`` (plain Python and
numpy in both packages; the port keeps its own copy). Two failure modes
matter on a long job: (a) hard loss of a worker, handled by
checkpoint/restore (``checkpoint.py``), and (b) soft degradation, a worker
whose steps slowly get 2-10x longer (thermals, ECC retries, a sick link).
``StepMonitor`` detects (b) from the step-time stream, without extra
collectives:

    monitor = StepMonitor(window=50, threshold=2.5)
    verdict = monitor.record(step, seconds)
    if verdict == "straggle": ...  # e.g. checkpoint and re-mesh

``TrainSupervisor`` wraps a train loop with retry from the latest
checkpoint: any exception (preemption, a worker killed for memory, an
interconnect timeout) restores and continues, up to ``max_restarts``.

One difference from the reference: the snapshot taken on a ``straggle``
verdict is labelled with the number of steps done (``step + 1``), as the
periodic saves are. The reference labels it ``step``, so a restart from
it would run that step a second time on a state that already holds it.
"""
from __future__ import annotations

import collections
import time
from typing import Callable, Optional

import numpy as np


class StepMonitor:
    """Rolling-median step-time watchdog."""

    def __init__(self, window: int = 50, threshold: float = 2.5,
                 min_samples: int = 10):
        self.times = collections.deque(maxlen=window)
        self.threshold = threshold
        self.min_samples = min_samples
        self.flagged = []

    def record(self, step: int, seconds: float) -> str:
        """Returns 'ok' | 'warmup' | 'straggle'."""
        if len(self.times) < self.min_samples:
            self.times.append(seconds)
            return "warmup"
        med = float(np.median(self.times))
        self.times.append(seconds)
        if seconds > self.threshold * med:
            self.flagged.append((step, seconds, med))
            return "straggle"
        return "ok"

    @property
    def median(self) -> Optional[float]:
        return float(np.median(self.times)) if self.times else None


class TrainSupervisor:
    """Retry-from-checkpoint wrapper around a step function.

    ``run(step_fn, state, start_step, num_steps)`` where
    ``step_fn(state, step) -> (state, metrics)`` may raise;
    ``save_fn(steps_done, state)`` and ``restore_fn() -> (state, step)``
    hook into the ``CheckpointManager``.
    """

    def __init__(self, save_fn: Callable, restore_fn: Callable,
                 save_every: int = 100, max_restarts: int = 3,
                 monitor: Optional[StepMonitor] = None):
        self.save_fn = save_fn
        self.restore_fn = restore_fn
        self.save_every = save_every
        self.max_restarts = max_restarts
        self.monitor = monitor or StepMonitor()
        self.restarts = 0

    def run(self, step_fn: Callable, state, start_step: int, num_steps: int):
        step = start_step
        metrics = None
        while step < num_steps:
            try:
                t0 = time.perf_counter()
                state, metrics = step_fn(state, step)
                dt = time.perf_counter() - t0
                verdict = self.monitor.record(step, dt)
                step += 1
                if verdict == "straggle" or step % self.save_every == 0:
                    # A straggle snapshot lets a re-mesh (elastic restore)
                    # pick up here.
                    self.save_fn(step, state)
            except Exception:
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise
                state, step = self.restore_fn()
        return state, metrics, step
