"""Synthetic load generation for the serving engine.

Counterpart of ``repro/serving/engine/loadgen.py`` (host-only Python;
the port keeps its own copy).

``poisson_trace`` draws a request stream with exponential inter-arrival
gaps (arrival times in engine steps — deterministic under a seed, so
benchmark rows and dry-run serving cells are comparable across PRs).
``run_load`` replays a trace against an engine: requests are submitted
when the engine clock reaches their arrival step, the engine steps until
drained, and the metrics summary is returned.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serving.batcher import Request


def poisson_trace(num_requests: int, rate: float, *, vocab_size: int,
                  seed: int = 0,
                  prompt_len: Tuple[int, int] = (4, 12),
                  max_new_tokens: Tuple[int, int] = (2, 8),
                  priorities: Sequence[int] = (0,),
                  deadline: Optional[float] = None) -> List[Request]:
    """Poisson arrivals at ``rate`` requests per engine step.

    prompt_len / max_new_tokens are inclusive [lo, hi] ranges sampled per
    request; ``deadline`` (if set) gives every request an admission
    deadline of arrival + deadline steps.
    """
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / rate, num_requests))
    trace = []
    for i in range(num_requests):
        plen = int(rng.integers(prompt_len[0], prompt_len[1] + 1))
        trace.append(Request(
            uid=i,
            prompt=rng.integers(0, vocab_size, plen).astype(np.int32),
            max_new_tokens=int(rng.integers(max_new_tokens[0],
                                            max_new_tokens[1] + 1)),
            priority=int(rng.choice(priorities)),
            deadline=(float(arrivals[i]) + deadline
                      if deadline is not None else None),
            arrival=float(arrivals[i]),
        ))
    return trace


def run_load(engine, trace: List[Request], *,
             max_steps: int = 100_000) -> dict:
    """Replay ``trace`` against ``engine``; returns the metrics summary."""
    pending = sorted(trace, key=lambda r: r.arrival)
    i = 0
    while i < len(pending) or not engine.idle:
        while i < len(pending) and pending[i].arrival <= engine.now:
            engine.submit(pending[i])
            i += 1
        if engine.now >= max_steps:
            raise RuntimeError(f"loadgen not drained after {max_steps} steps")
        engine.step()
    return engine.metrics.summary()
