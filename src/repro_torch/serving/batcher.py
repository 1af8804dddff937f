"""Request batching: the host-side slot layer of the serving stack.

Counterpart of ``repro/serving/batcher.py`` (host-only numpy code; the port
keeps its own copy). ``Request`` is the request record: prompt, limits,
scheduling attributes (priority / deadline, read by the engine's scheduler
when it is ported) and the generated-token and uncertainty traces filled in
as the request moves through decode.

``Batcher`` collects requests into fixed-size decode batches (idle slots
stay empty), tracks per-slot occupancy, and evicts finished or abstained
requests. ``serving/engine/state.py``'s pools follow the same slot
discipline and also own the per-slot KV mean / variance device buffers.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Deque, List, Optional

import numpy as np


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray          # (T,) int32
    max_new_tokens: int = 16
    # Scheduling attributes (consumed by engine/scheduler.py; the lite
    # Batcher is FIFO and ignores them).
    priority: int = 0           # lower = more urgent
    deadline: Optional[float] = None  # engine-step deadline for admission
    arrival: float = 0.0        # engine-step arrival time (loadgen)
    prefill_only: bool = False  # disaggregation: fill pages, generate nothing
    # Set by the scheduler at first admission; preserved across preemption
    # requeues so the aging clock keeps a request's accumulated promotion.
    first_enqueue: Optional[float] = None
    preempted: int = 0          # times this request was preempted mid-flight
    # Filled in during decode.
    generated: list = dataclasses.field(default_factory=list)
    mi_trace: list = dataclasses.field(default_factory=list)
    abstained: bool = False
    escalated: int = 0          # number of SVI second-opinion passes taken
    done: bool = False
    finish_reason: Optional[str] = None  # 'length'|'eos'|'abstain'|...

    def finish(self, reason: str) -> None:
        self.done = True
        self.finish_reason = reason


class Batcher:
    def __init__(self, batch_size: int, max_len: int):
        self.batch_size = batch_size
        self.max_len = max_len
        self.slots: List[Optional[Request]] = [None] * batch_size
        self.queue: Deque[Request] = collections.deque()

    def submit(self, req: Request):
        self.queue.append(req)

    def fill_slots(self):
        """Admit queued requests into free slots. Returns new admissions."""
        admitted = []
        for i in range(self.batch_size):
            if self.slots[i] is None and self.queue:
                self.slots[i] = self.queue.popleft()
                admitted.append((i, self.slots[i]))
        return admitted

    def active(self):
        return [(i, r) for i, r in enumerate(self.slots) if r is not None]

    def evict(self, slot: int, reason: str) -> Optional[Request]:
        """Free ``slot`` and return the evicted request (None if idle).

        The returned request carries ``finish_reason`` so callers can
        distinguish abstain-evict from completion-evict.
        """
        req = self.slots[slot]
        if req is None:
            return None
        req.finish(reason)
        self.slots[slot] = None
        return req

    def record(self, slot: int, token: int, mi: float,
               abstain: bool, eos: Optional[int] = None) -> Optional[Request]:
        """Record one decoded token; returns the evicted Request when this
        token finished the request (abstention, eos or length), else None."""
        req = self.slots[slot]
        if req is None:
            return None
        req.generated.append(int(token))
        req.mi_trace.append(float(mi))
        if abstain:
            req.abstained = True
            return self.evict(slot, "abstain")
        if eos is not None and token == eos:
            return self.evict(slot, "eos")
        if len(req.generated) >= req.max_new_tokens:
            return self.evict(slot, "length")
        return None

    @property
    def idle(self) -> bool:
        return not self.queue and all(s is None for s in self.slots)
