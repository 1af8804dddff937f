"""Serve-time telemetry for the engine, backed by the unified metrics
registry (``repro_torch.obs``).

Counterpart of ``repro/serving/engine/metrics.py`` (host-only Python;
the port keeps its own copy).

Every counter the old hand-rolled attribute bag carried is now a
registry family — same event-method API, same attribute reads
(``metrics.tokens_generated`` still works; it reads the counter), same
``summary()`` keys — plus:

  * a ``MetricsRegistry`` snapshot / Prometheus export per engine;
  * the uncertainty telemetry block (router-band occupancy, escalation
    outcomes, ECE-style calibration over the MI stream, OOD alarms);
  * a shared :class:`~repro_torch.obs.registry.Stopwatch` wall clock — a fleet
    hands every replica THE SAME clock, so pooled throughput equals the
    sum of per-replica throughputs instead of drifting by per-replica
    start skew.

Still pure host bookkeeping — one small int update per event, nothing on
the device path.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

from repro_torch.obs.registry import MetricsRegistry, Stopwatch, percentile
from repro_torch.obs.uncertainty import UncertaintyTelemetry

__all__ = ["EngineMetrics", "RequestRecord", "percentile"]


@dataclasses.dataclass
class RequestRecord:
    uid: int
    arrival: float            # engine step of submission
    admit_step: float
    finish_step: float
    wall_latency_s: float
    tokens: int
    escalations: int
    finish_reason: Optional[str]

    @property
    def latency_steps(self) -> float:
        return self.finish_step - self.arrival


# name -> help text; attribute reads (metrics.<name>) resolve to the
# counter's value via __getattr__, so every pre-registry caller still
# works unchanged.
_COUNTERS = {
    "submitted": "requests offered to the scheduler",
    "rejected": "requests the scheduler refused at submission",
    "expired": "requests deadline-expired in the waiting room",
    "admitted": "requests allocated a slot",
    "completed": "requests finished serving (non-abstain)",
    "abstained": "requests evicted by an abstain decision",
    "escalations": "SVI second-opinion passes taken",
    "tokens_generated": "tokens served",
    "prefill_tokens": "prompt tokens prefilled",
    "steps": "engine steps",
    # paged-pool telemetry (stays zero on the contiguous layout)
    "preemptions": "slots evicted mid-flight under page pressure",
    "requeue_overflows": "waiters displaced by preemption requeues",
    "defrags": "page-pool defragmentations",
    # prefix-sharing telemetry (stays zero without a prefix index)
    "prefix_hits": "admissions that mapped shared pages",
    "prefix_misses": "admissions that found no prefix",
    "prefix_shared_pages": "pages mapped shared at admission",
    "prefill_tokens_saved": "prompt tokens NOT prefilled (shared)",
    "cow_copies": "copy-on-write page duplications",
    # speculative-decode + amortized-escalation telemetry
    "spec_rounds": "draft->verify->accept rounds run",
    "draft_tokens": "tokens proposed by the mean draft",
    "accepted_draft_tokens": "drafted tokens served after verify",
    "verify_passes": "chunked PFP block-verify passes",
    "decode_passes": "plain (1-token) PFP decode passes",
    "draft_passes": "mean-only draft decode passes",
    "svi_passes": "SVI second-opinion passes launched",
    # MoE routing telemetry (stays zero on dense families)
    "moe_dropped_assignments": "routed (token, expert) assignments dropped "
                               "at capacity",
    "moe_assignments": "routed (token, expert) assignments offered",
}


class EngineMetrics:
    def __init__(self, clock: Optional[Stopwatch] = None):
        self.registry = MetricsRegistry()
        self.clock = clock if clock is not None else Stopwatch()
        self._c = {name: self.registry.counter(name, help)
                   for name, help in _COUNTERS.items()}
        self._occ = self.registry.gauge("occupancy", "occupied slots")
        self._live_pages = self.registry.gauge("live_pages",
                                               "live pool pages")
        self._moe_drop_rate = self.registry.gauge(
            "moe_drop_rate", "fraction of routed assignments dropped at "
            "expert capacity (cumulative)")
        self.uncertainty = UncertaintyTelemetry(self.registry)
        self.records: List[RequestRecord] = []
        self.occupancy_trace: List[int] = []
        # (live, total, frag[, shared, held]) per step; the last two ride
        # along when the engine runs prefix sharing.
        self.page_trace: List[Tuple[int, ...]] = []
        self.escalation_batches: List[int] = []  # slots per batched SVI pass
        self.svi_pass_trace: List[int] = []      # SVI passes per engine step
        self._svi_passes_prev = 0
        self._admit_times = {}     # uid -> (arrival_step, admit_step, wall_t0)

    def __getattr__(self, name):
        # Only reached when normal attribute lookup fails: legacy counter
        # reads resolve to the registry child's value.
        c = self.__dict__.get("_c")
        if c is not None and name in c:
            return c[name].value
        raise AttributeError(name)

    def set_clock(self, clock: Stopwatch) -> None:
        """Adopt a shared wall clock (fleet wiring; call before the first
        event for a consistent time base)."""
        self.clock = clock

    @property
    def peak_occupancy(self) -> int:
        return int(self._occ._solo().peak)

    @property
    def peak_live_pages(self) -> int:
        return int(self._live_pages._solo().peak)

    # -- events -------------------------------------------------------------
    def on_submit(self, accepted: bool) -> None:
        self.clock.start()
        self._c["submitted"].inc()
        if not accepted:
            self._c["rejected"].inc()

    def on_expire(self, n: int = 1) -> None:
        self._c["expired"].inc(n)

    def on_admit(self, uid: int, arrival: float, now: float) -> None:
        self._c["admitted"].inc()
        self._admit_times[uid] = (arrival, now, time.perf_counter())

    def on_prefill(self, tokens: int) -> None:
        self._c["prefill_tokens"].inc(tokens)

    def on_token(self, n: int = 1) -> None:
        self._c["tokens_generated"].inc(n)

    def on_escalation(self, n: int = 1) -> None:
        self._c["escalations"].inc(n)

    def on_decision(self, mi: float, band: str) -> None:
        """One routed token's raw router band (before SVI resolution)."""
        self.uncertainty.on_decision(mi, band)

    def on_escalation_outcome(self, pfp_mi: float, pfp_token: int,
                              svi_mi: float, svi_token: int,
                              outcome: str) -> None:
        self.uncertainty.on_escalation_outcome(
            pfp_mi, pfp_token, svi_mi, svi_token, outcome)

    def on_finish(self, req, now: float) -> None:
        arrival, admit, wall_t0 = self._admit_times.pop(
            req.uid, (now, now, time.perf_counter()))
        if req.finish_reason == "abstain":
            self._c["abstained"].inc()
        else:
            self._c["completed"].inc()
        self.records.append(RequestRecord(
            uid=req.uid, arrival=arrival, admit_step=admit, finish_step=now,
            wall_latency_s=time.perf_counter() - wall_t0,
            tokens=len(req.generated), escalations=req.escalated,
            finish_reason=req.finish_reason))

    def on_preemption(self, n: int = 1) -> None:
        self._c["preemptions"].inc(n)

    def on_requeue_overflow(self, n: int = 1) -> None:
        """A preemption requeue found the waiting room full and displaced
        the newest un-started waiter (finished as 'requeue_overflow')."""
        self._c["requeue_overflows"].inc(n)

    def on_defrag(self, n: int = 1) -> None:
        self._c["defrags"].inc(n)

    def on_prefix(self, tokens_saved: int, pages_shared: int) -> None:
        """One admission's prefix-index outcome: ``tokens_saved`` prompt
        tokens whose prefill is skipped (their k/v rows arrived via shared
        pages), over ``pages_shared`` mapped pages. (0, 0) is a miss."""
        if pages_shared > 0:
            self._c["prefix_hits"].inc()
            self._c["prefix_shared_pages"].inc(pages_shared)
            self._c["prefill_tokens_saved"].inc(tokens_saved)
        else:
            self._c["prefix_misses"].inc()

    def on_cow(self, n: int = 1) -> None:
        self._c["cow_copies"].inc(n)

    def on_spec_round(self, drafted: int, accepted: int) -> None:
        """One draft->verify->accept round: ``drafted`` tokens proposed by
        the mean-only draft, ``accepted`` of them served after the chunked
        PFP verify (the verify pass itself lands via on_verify_pass)."""
        self._c["spec_rounds"].inc()
        self._c["draft_tokens"].inc(drafted)
        self._c["accepted_draft_tokens"].inc(accepted)

    def on_verify_pass(self, n: int = 1) -> None:
        self._c["verify_passes"].inc(n)

    def on_decode_pass(self, n: int = 1) -> None:
        self._c["decode_passes"].inc(n)

    def on_draft_pass(self, n: int = 1) -> None:
        self._c["draft_passes"].inc(n)

    def on_moe_drop(self, dropped: float, assignments: float) -> None:
        """One MoE forward's drop accounting: ``dropped`` of
        ``assignments`` routed (token, expert) pairs hit a full expert and
        were zeroed. Updates the cumulative ``moe_drop_rate`` gauge."""
        self._c["moe_dropped_assignments"].inc(int(dropped))
        self._c["moe_assignments"].inc(int(assignments))
        total = self._c["moe_assignments"].value
        if total:
            self._moe_drop_rate.set(
                self._c["moe_dropped_assignments"].value / total)

    def on_svi_pass(self, batch: int = 1) -> None:
        """One SVI second-opinion launch resolving ``batch`` slots at once
        (the sequential path calls this with batch=1 per escalation)."""
        self._c["svi_passes"].inc()
        self.escalation_batches.append(batch)

    def on_step(self, occupancy: int,
                pages: Optional[Tuple[int, ...]] = None) -> None:
        """``pages``: (live_pages, total_pages, fragmented_pages) — plus
        (shared_pages, prefix_held_pages) under prefix sharing — from a
        paged pool; omitted by the contiguous engine."""
        self._c["steps"].inc()
        self.occupancy_trace.append(occupancy)
        self._occ.set(occupancy)
        if pages is not None:
            self.page_trace.append(pages)
            self._live_pages.set(pages[0])
        # Per-step SVI-pass delta: the "<= 1 SVI pass per engine step"
        # bar for batched escalation is max(svi_pass_trace) <= 1.
        svi = self._c["svi_passes"].value
        self.svi_pass_trace.append(svi - self._svi_passes_prev)
        self._svi_passes_prev = svi

    # -- reduction ----------------------------------------------------------
    def summary(self) -> dict:
        elapsed = self.clock.elapsed()
        lat_steps = [r.latency_steps for r in self.records]
        lat_wall = [r.wall_latency_s for r in self.records]
        finished = len(self.records)
        occ = self.occupancy_trace
        c = {name: fam.value for name, fam in self._c.items()}
        out = {
            "submitted": c["submitted"],
            "rejected": c["rejected"],
            "expired": c["expired"],
            "admitted": c["admitted"],
            "finished": finished,
            "completed": c["completed"],
            "abstained": c["abstained"],
            "abstain_rate": c["abstained"] / max(finished, 1),
            "escalations": c["escalations"],
            "escalation_rate": c["escalations"] / max(
                c["tokens_generated"], 1),
            "tokens_generated": c["tokens_generated"],
            "prefill_tokens": c["prefill_tokens"],
            "steps": c["steps"],
            "elapsed_s": elapsed,
            "throughput_tok_s": c["tokens_generated"] / max(elapsed, 1e-9),
            "p50_latency_steps": percentile(lat_steps, 50),
            "p99_latency_steps": percentile(lat_steps, 99),
            "p50_latency_s": percentile(lat_wall, 50),
            "p99_latency_s": percentile(lat_wall, 99),
            "peak_occupancy": self.peak_occupancy,
            "mean_occupancy": sum(occ) / max(len(occ), 1),
            "final_occupancy": occ[-1] if occ else 0,
            # paged-pool gauges (all zero on the contiguous layout)
            "preemptions": c["preemptions"],
            "requeue_overflow": c["requeue_overflows"],
            "defrags": c["defrags"],
            "peak_page_occupancy": (
                self.peak_live_pages / self.page_trace[0][1]
                if self.page_trace else 0.0),
            "mean_page_occupancy": (
                sum(t[0] for t in self.page_trace)
                / max(len(self.page_trace), 1)
                / self.page_trace[0][1] if self.page_trace else 0.0),
            "mean_page_fragmentation": (
                sum(t[2] for t in self.page_trace)
                / max(len(self.page_trace), 1) if self.page_trace else 0.0),
            "final_live_pages": self.page_trace[-1][0] if self.page_trace
            else 0,
            # prefix-sharing gauges (all zero without a prefix index)
            "prefix_hits": c["prefix_hits"],
            "prefix_misses": c["prefix_misses"],
            "prefix_hit_rate": c["prefix_hits"] / max(
                c["prefix_hits"] + c["prefix_misses"], 1),
            "prefix_shared_pages": c["prefix_shared_pages"],
            "prefill_tokens_saved": c["prefill_tokens_saved"],
            # fraction of prefill FLOPs the prefix index saved: PFP
            # prefill cost is linear in prompt tokens fed, so the token
            # ratio is the FLOP ratio
            "prefill_frac_saved": c["prefill_tokens_saved"] / max(
                c["prefill_tokens_saved"] + c["prefill_tokens"], 1),
            "cow_copies": c["cow_copies"],
            "mean_shared_pages": (
                sum(t[3] for t in self.page_trace if len(t) > 3)
                / max(len(self.page_trace), 1)),
            "final_prefix_held_pages": (
                self.page_trace[-1][4]
                if self.page_trace and len(self.page_trace[-1]) > 4 else 0),
            # speculative-decode + amortized-escalation gauges (all zero
            # when speculation is off and nothing escalates)
            "spec_rounds": c["spec_rounds"],
            "draft_tokens": c["draft_tokens"],
            "accepted_draft_tokens": c["accepted_draft_tokens"],
            "draft_acceptance_rate": c["accepted_draft_tokens"] / max(
                c["draft_tokens"], 1),
            "accepted_tokens_per_verify": c["accepted_draft_tokens"] / max(
                c["verify_passes"], 1),
            "verify_passes": c["verify_passes"],
            "decode_passes": c["decode_passes"],
            "draft_passes": c["draft_passes"],
            "svi_passes": c["svi_passes"],
            "svi_passes_per_step": c["svi_passes"] / max(c["steps"], 1),
            "max_svi_passes_per_step": (max(self.svi_pass_trace)
                                        if self.svi_pass_trace else 0),
            "mean_escalation_batch": (
                sum(self.escalation_batches)
                / max(len(self.escalation_batches), 1)),
            "max_escalation_batch": (max(self.escalation_batches)
                                     if self.escalation_batches else 0),
            # full-PFP passes per served token: decode passes serve one
            # token each, verify passes serve up to K — speculation wins
            # when this drops below 1.0
            "pfp_passes_per_token": (c["decode_passes"] + c["verify_passes"])
            / max(c["tokens_generated"], 1),
            # MoE routing gauges (all zero on dense families)
            "moe_dropped_assignments": c["moe_dropped_assignments"],
            "moe_assignments": c["moe_assignments"],
            "moe_drop_rate": c["moe_dropped_assignments"] / max(
                c["moe_assignments"], 1),
        }
        out.update(self.uncertainty.summary())
        return out
