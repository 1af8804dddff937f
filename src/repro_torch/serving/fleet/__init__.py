"""Multi-replica, prefill/decode-disaggregated serving tier (counterpart
of ``repro/serving/fleet/``).

See ``serving/engine`` for the single-engine lifecycle this tier
composes; the fleet-level pieces are:

  * ``PrefixRouter`` — cross-replica admission routing: each replica's
    radix prefix index doubles as a routing table (send a request to the
    replica already holding the longest cached prefix of its prompt;
    fall back to the least-loaded replica when nothing usable is cached).
  * ``DisaggPair`` — prefill/decode disaggregation inside one replica: a
    prefill engine fills pages into the shared refcounted pool, and the
    finished lineage is handed to a decode engine through the prefix
    index (``hold``/``share``), so decode admission never waits behind a
    long prompt.
  * ``Fleet`` — R data-parallel replicas behind one admission frontend,
    with fleet-level metrics (per-replica occupancy, routing hit-rate,
    handoff latency in steps).

Determinism: uncertainty sampling is keyed per (request uid, token
index), so WHERE a request decodes — which replica, which slot, before
or after a handoff — is invisible to the math. Routed fleet output is
bit-for-bit the single-engine baseline's (tokens AND MI traces).
"""
from repro_torch.serving.fleet.fleet import Fleet, FleetConfig
from repro_torch.serving.fleet.handoff import SHADOW_UID_BASE, DisaggPair
from repro_torch.serving.fleet.metrics import (FleetMetrics,
                                               pooled_handoff_gauges)
from repro_torch.serving.fleet.router import PrefixRouter

__all__ = [
    "Fleet", "FleetConfig", "FleetMetrics", "pooled_handoff_gauges",
    "DisaggPair", "SHADOW_UID_BASE",
    "PrefixRouter",
]
