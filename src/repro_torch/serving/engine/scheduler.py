"""Admission-controlled request scheduling for the serving engine.

Counterpart of ``repro/serving/engine/scheduler.py`` (host-only Python;
the port keeps its own copy).

The scheduler owns the waiting-room side of continuous batching:

  * admission control — a bounded queue (``max_queue``) plus a static
    feasibility check (prompt + generation budget must fit the engine's
    ``max_len``); both reject at submit time so overload never grows
    unbounded host state;
  * priority/deadline ordering — requests carry ``priority`` (lower = more
    urgent) and an optional admission ``deadline`` in engine steps.
    Selection is by *effective* priority, which ages toward urgent as a
    request waits (one level per ``aging_steps``), so a stream of hot
    requests cannot starve a cold one indefinitely; ties break FIFO.
    Requests whose deadline passes before admission are dropped (expired);
  * chunked prefill planning — ``plan_prefill`` hands the engine at most
    ``prefill_budget`` prompt tokens per engine step, in chunks of at most
    ``prefill_chunk``, round-robin over admitted-but-still-prefilling
    slots. Long prompts therefore trickle into their KV slots across
    steps instead of stalling the whole decode batch behind one giant
    prefill pass. ``plan_prefill_rounds`` regroups the same plan into
    rounds of at most one chunk per slot — the paged engine executes each
    round as ONE batched multi-slot prefill pass over the shared page
    pool;
  * page-budget admission — with a paged decode pool the binding resource
    is pages, not slots: ``pop_ready`` also checks the candidate's page
    need (:func:`pages_for`, or the caller's ``page_need`` override — a
    prefix-sharing engine discounts pages the request would map SHARED,
    since a shared page costs the pool budget once) against the pool's
    free pages, and blocks the queue head rather than skipping it, so
    page pressure can never invert priority order. ``requeue`` re-inserts
    a PREEMPTED request (pages reclaimed mid-flight by a more senior
    slot) without admission checks — preemption must not lose requests.
    Speculative decoding changes none of this arithmetic: a verify block
    never runs past ``max_new_tokens``, so the prompt + generation pages
    :func:`pages_for` reserves at admission already cover every
    speculative write the slot can make.

Pure host logic: no torch imports; the engine executes the plans.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Sequence, Tuple

from repro_torch.serving.batcher import Request


def pages_for(req: Request, page_size: int, *, reserve: bool = True) -> int:
    """Pages a request needs before it can make progress.

    reserve=True (conservative): the full prompt + generation budget —
    admission reserves everything up front, so a request can never be
    preempted for pages. reserve=False (optimistic): the rows it must
    write before producing its next token — prompt, tokens already
    generated (re-prefilled after a preemption), and one decode row;
    later pages are claimed on demand, which packs more live slots per
    page but can preempt.
    """
    if reserve:
        tokens = len(req.prompt) + req.max_new_tokens
    else:
        tokens = len(req.prompt) + len(req.generated) + 1
    return math.ceil(tokens / page_size)


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    max_queue: int = 64       # admission control: queue depth bound
    aging_steps: int = 8      # waiting steps per priority-level promotion
    prefill_chunk: int = 8    # max tokens per prefill chunk
    prefill_budget: int = 16  # max prefill tokens executed per engine step

    def __post_init__(self):
        if min(self.max_queue, self.aging_steps, self.prefill_chunk,
               self.prefill_budget) < 1:
            raise ValueError("SchedulerConfig fields must all be >= 1")


class RequestScheduler:
    """Priority/deadline queue with aging and prefill chunk planning."""

    def __init__(self, config: SchedulerConfig = SchedulerConfig(), *,
                 max_len: Optional[int] = None):
        self.config = config
        self.max_len = max_len
        self._queue: List[Tuple[int, float, Request]] = []  # (seq, enq, req)
        self._expired_pending: List[Request] = []
        self._seq = 0
        self.rejected = 0
        self.expired = 0
        self.submitted = 0
        self.requeue_overflow = 0  # waiters displaced by preemption requeues

    def __len__(self) -> int:
        return len(self._queue)

    def _purge_expired(self, now: float) -> None:
        kept = []
        for item in self._queue:
            req = item[2]
            if req.deadline is not None and now > req.deadline:
                req.finish("expired")
                self._expired_pending.append(req)
                self.expired += 1
            else:
                kept.append(item)
        self._queue = kept

    def drain_expired(self, now: float) -> List[Request]:
        """Purge and return deadline-expired waiters. The engine calls this
        every step so dead entries never hold the bounded queue — even
        while the slot pool is full and nothing is being popped."""
        self._purge_expired(now)
        out = self._expired_pending
        self._expired_pending = []
        return out

    # -- admission ----------------------------------------------------------
    def submit(self, req: Request, now: float) -> bool:
        """Admit ``req`` into the waiting queue. False = rejected."""
        self.submitted += 1
        self._purge_expired(now)  # expired waiters must not reject live ones
        if len(self._queue) >= self.config.max_queue:
            self.rejected += 1
            return False
        if len(req.prompt) == 0:
            # an empty prompt can never produce a prefill chunk, so the
            # slot would sit in 'prefill' phase forever — reject upfront
            self.rejected += 1
            return False
        if self.max_len is not None and \
                len(req.prompt) + req.max_new_tokens > self.max_len:
            self.rejected += 1
            return False
        if req.first_enqueue is None:
            req.first_enqueue = now  # aging clock epoch; survives requeues
        self._queue.append((self._seq, now, req))
        self._seq += 1
        return True

    # -- selection ----------------------------------------------------------
    def _effective_priority(self, enq: float, req: Request,
                            now: float) -> float:
        aged = int(now - enq) // max(self.config.aging_steps, 1)
        return req.priority - aged

    def pop_ready(self, now: float, *, free_pages: Optional[int] = None,
                  page_size: Optional[int] = None,
                  reserve_pages: bool = True,
                  page_need: Optional[Callable[[Request], int]] = None,
                  ) -> Tuple[Optional[Request], List[Request]]:
        """Pop the most urgent admissible request.

        With ``free_pages``/``page_size`` set (paged engine), admission is
        by page budget: if the most urgent request's page need does not
        fit, NOTHING is popped — blocking the head instead of skipping to
        a smaller request keeps page pressure from inverting priority
        order (the head is admitted as soon as evictions free its pages).

        ``page_need`` overrides the default :func:`pages_for` math: a
        prefix-sharing engine passes a callable that discounts pages the
        request would map SHARED from the prefix index — a shared page is
        already paid for in the pool budget, so it must cost the admission
        check nothing (only the non-shared suffix, plus one page for the
        copy-on-write of a partially-shared boundary page, counts).

        Returns (request | None, expired) — ``expired`` are requests whose
        admission deadline passed while waiting; they are dropped here so
        the caller can account for them.
        """
        expired = self.drain_expired(now)
        if not self._queue:
            return None, expired
        best = min(
            self._queue,
            key=lambda it: (self._effective_priority(it[1], it[2], now),
                            it[0]))
        if free_pages is not None and page_size is not None:
            need = (page_need(best[2]) if page_need is not None
                    else pages_for(best[2], page_size, reserve=reserve_pages))
            if need > free_pages:
                return None, expired
        self._queue.remove(best)
        return best[2], expired

    def requeue(self, req: Request, now: float) -> Optional[Request]:
        """Re-insert a preempted request. Admission control is skipped —
        the request was already admitted once and its pages were taken
        back mid-flight; dropping it here would turn preemption into
        silent request loss. The deadline is cleared for the same reason:
        it bounds ADMISSION (batcher.Request), which this request already
        passed on time — leaving it set would let the next expiry purge
        finish a mid-generation request as 'expired'. FIFO seq is fresh,
        so among equals it waits behind current waiters — but the aging
        clock is the ORIGINAL enqueue time (``first_enqueue``), so the
        promotion a request accumulated while waiting survives every
        preemption; a repeatedly-preempted request keeps climbing instead
        of being reset behind a hot stream.

        Depth stays bounded: when the waiting room is already at
        ``max_queue``, the preempted request displaces the NEWEST
        un-started waiter (finished as ``'requeue_overflow'`` and
        returned to the caller for accounting) — preempted requests are
        never dropped, and never displace each other. If every waiter is
        itself preempted, the queue is allowed to overflow temporarily:
        each preemption frees a slot, so at most ``slots`` such requeues
        can ever be outstanding at once.
        """
        req.deadline = None
        req.preempted += 1
        enq = req.first_enqueue if req.first_enqueue is not None else now
        displaced: Optional[Request] = None
        if len(self._queue) >= self.config.max_queue:
            fresh = [it for it in self._queue if it[2].preempted == 0]
            if fresh:
                victim = max(fresh, key=lambda it: it[0])
                self._queue.remove(victim)
                displaced = victim[2]
                displaced.finish("requeue_overflow")
                self.requeue_overflow += 1
        self._queue.append((self._seq, enq, req))
        self._seq += 1
        return displaced

    # -- chunked prefill ----------------------------------------------------
    def plan_prefill(
        self, prefilling: Sequence[Tuple[int, int]],
    ) -> List[Tuple[int, int]]:
        """Plan this step's prefill work.

        prefilling: admission-ordered (slot, remaining_prompt_tokens).
        Returns [(slot, num_tokens)] consuming at most ``prefill_budget``
        tokens total, each piece at most ``prefill_chunk``, round-robin so
        one long prompt cannot monopolize the budget.
        """
        budget = self.config.prefill_budget
        remaining = {slot: rem for slot, rem in prefilling}
        order = [slot for slot, _ in prefilling]
        plan: List[Tuple[int, int]] = []
        while budget > 0 and any(remaining[s] > 0 for s in order):
            for slot in order:
                if budget <= 0:
                    break
                if remaining[slot] <= 0:
                    continue
                n = min(self.config.prefill_chunk, remaining[slot], budget)
                plan.append((slot, n))
                remaining[slot] -= n
                budget -= n
        return plan

    def plan_prefill_rounds(
        self, prefilling: Sequence[Tuple[int, int]],
    ) -> List[List[Tuple[int, int]]]:
        """The same plan as :meth:`plan_prefill`, regrouped into rounds
        with at most one chunk per slot each. The paged engine runs every
        round as ONE batched multi-slot prefill pass (all planned slots'
        chunks in a single lockstep forward over the shared page pool),
        so the number of device dispatches per step is the number of
        rounds, not the number of chunks."""
        rounds: List[List[Tuple[int, int]]] = []
        counts: dict = {}
        for slot, n in self.plan_prefill(prefilling):
            r = counts.get(slot, 0)
            counts[slot] = r + 1
            if len(rounds) <= r:
                rounds.append([])
            rounds[r].append((slot, n))
        return rounds
