"""Fleet-level telemetry: routing, per-replica occupancy, handoffs.

Counterpart of ``repro/serving/fleet/metrics.py`` (host-only Python; the
port keeps its own copy).

``FleetMetrics`` owns the counters only the frontend can see (where each
request was routed and why); everything per-replica is pulled from the
replicas' own summaries at reduction time, so no event is double-booked.

One wall clock for the whole fleet: the frontend constructs a shared
:class:`~repro_torch.obs.registry.Stopwatch` and hands it to every
replica's ``EngineMetrics``, and ``summary()`` freezes it while
collecting — so the pooled ``throughput_tok_s`` is EXACTLY the sum of
the per-replica throughputs.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

from repro_torch.obs.registry import MetricsRegistry, Stopwatch, percentile

# Replica work counters summed into the fleet summary (request-stream
# counters like submitted/rejected live at the fleet boundary instead).
_SUM_KEYS = (
    "expired", "admitted", "finished", "completed", "abstained",
    "escalations", "tokens_generated", "prefill_tokens", "preemptions",
    "requeue_overflow", "prefix_hits", "prefix_misses",
    "prefix_shared_pages", "prefill_tokens_saved", "cow_copies",
    "decode_passes", "verify_passes", "draft_passes", "svi_passes",
    # uncertainty telemetry pools by summation too
    "band_continue", "band_escalate", "band_abstain", "ood_alarms",
    "escalate_continue", "escalate_abstain",
)


class FleetMetrics:
    def __init__(self, num_replicas: int,
                 replica_summaries: Optional[Callable[[], List[dict]]] = None,
                 pair_gauges: Optional[Callable[[], dict]] = None,
                 clock: Optional[Stopwatch] = None):
        self.num_replicas = num_replicas
        self._replica_summaries = replica_summaries
        self._pair_gauges = pair_gauges
        self.registry = MetricsRegistry()
        self.clock = clock if clock is not None else Stopwatch()
        self._c = {
            "submitted": self.registry.counter(
                "submitted", "requests offered to the fleet"),
            "rejected": self.registry.counter(
                "rejected", "requests the routed replica refused"),
            "route_prefix_hits": self.registry.counter(
                "route_prefix_hits", "routed to a replica's cached prefix"),
            "route_fallbacks": self.registry.counter(
                "route_fallbacks", "routed least-loaded (nothing cached)"),
            "route_tokens_matched": self.registry.counter(
                "route_tokens_matched",
                "cached tokens at the routed replica"),
            "steps": self.registry.counter("steps", "fleet ticks"),
        }
        # per-step tuple of each replica's occupied slots
        self.occupancy_trace: List[Tuple[int, ...]] = []

    def __getattr__(self, name):
        c = self.__dict__.get("_c")
        if c is not None and name in c:
            return c[name].value
        raise AttributeError(name)

    # -- events -------------------------------------------------------------
    def on_route(self, replica: int, matched: int, prefix_hit: bool,
                 accepted: bool) -> None:
        self.clock.start()
        self._c["submitted"].inc()
        if not accepted:
            self._c["rejected"].inc()
            return
        if prefix_hit:
            self._c["route_prefix_hits"].inc()
            self._c["route_tokens_matched"].inc(matched)
        else:
            self._c["route_fallbacks"].inc()

    def on_step(self, occupancies: Tuple[int, ...]) -> None:
        self._c["steps"].inc()
        self.occupancy_trace.append(occupancies)

    # -- reduction ----------------------------------------------------------
    @property
    def route_hit_rate(self) -> float:
        routed = self.route_prefix_hits + self.route_fallbacks
        return self.route_prefix_hits / max(routed, 1)

    def summary(self) -> dict:
        # Freeze the shared clock across the whole reduction: every
        # replica summary reads the same elapsed value, so the pooled
        # throughput below is exactly the per-replica sum.
        with self.clock.frozen():
            reps = (self._replica_summaries() if self._replica_summaries
                    else [])
            elapsed = self.clock.elapsed()
        out = {k: sum(r.get(k, 0) for r in reps) for k in _SUM_KEYS}
        out["prefix_hit_rate"] = out["prefix_hits"] / max(
            out["prefix_hits"] + out["prefix_misses"], 1)
        out["elapsed_s"] = elapsed
        out["throughput_tok_s"] = \
            out["tokens_generated"] / max(elapsed, 1e-9)
        out.update({
            "replicas": self.num_replicas,
            "submitted": self.submitted,
            "rejected": self.rejected,
            "steps": self.steps,
            "route_prefix_hits": self.route_prefix_hits,
            "route_fallbacks": self.route_fallbacks,
            "route_hit_rate": self.route_hit_rate,
            "route_tokens_matched": self.route_tokens_matched,
        })
        occ = self.occupancy_trace
        per_replica_occ = [
            [t[i] for t in occ] for i in range(self.num_replicas)]
        out["per_replica_mean_occupancy"] = [
            sum(o) / max(len(o), 1) for o in per_replica_occ]
        out["per_replica_peak_occupancy"] = [
            max(o) if o else 0 for o in per_replica_occ]
        out["final_occupancy"] = sum(occ[-1]) if occ else 0
        out["per_replica_tokens"] = [
            r.get("tokens_generated", 0) for r in reps]
        out["per_replica_throughput_tok_s"] = [
            r.get("throughput_tok_s", 0.0) for r in reps]
        # latency percentiles over the POOLED request records would need
        # raw traces; p50/p99 of the per-replica p50/p99s is not that.
        # Expose the per-replica values instead of a misleading merge.
        out["per_replica_p50_latency_steps"] = [
            r.get("p50_latency_steps", 0.0) for r in reps]
        out["per_replica_p99_latency_steps"] = [
            r.get("p99_latency_steps", 0.0) for r in reps]
        if self._pair_gauges is not None:
            out.update(self._pair_gauges())
        return out


def pooled_handoff_gauges(pairs) -> dict:
    """Disaggregation gauges pooled over a fleet's ``DisaggPair``
    replicas (raw latency lists pool exactly, unlike percentiles)."""
    lat = [s for p in pairs for s in p.handoff_latencies]
    return {
        "handoffs": len(lat),
        "p50_handoff_steps": percentile(lat, 50),
        "p99_handoff_steps": percentile(lat, 99),
        "decode_steps_during_peer_prefill": sum(
            p.overlap_steps for p in pairs),
    }
