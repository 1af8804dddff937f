"""Observability for the port's serving stack (counterpart of
``repro/obs/``), all host-side bookkeeping:

  * ``registry`` — Counter / Gauge / Histogram metric families with label
    sets, a shared ``Stopwatch`` wall clock, and Prometheus text export;
    ``EngineMetrics`` and ``FleetMetrics`` are backed by one
    ``MetricsRegistry`` each;
  * ``trace`` — deterministic structured request tracing keyed on
    ``(engine_step, seq)``, exported as JSONL or Chrome trace-event JSON;
  * ``profiler`` — opt-in per-op, per-impl timing at the dispatch
    registry (``core/dispatch.py``), each op fenced with
    ``torch.cuda.synchronize`` on the card, plus tuning-cache consult
    counters: the paper's Table-4 breakdown of the pass the engine serves;
  * ``uncertainty`` — router-band occupancy, escalation-outcome counters,
    ECE-style calibration over the MI stream and a thresholded OOD alarm.

``runmeta`` / ``schema`` / ``validate`` round it out with run provenance
(git sha, device kind, backend, torch and CUDA versions, the card's power
limit, TF32 off), a dependency-free JSON-schema subset validator, and the
``python -m repro_torch.obs.validate`` CLI.
"""
from repro_torch.obs.profiler import OpProfiler, profile_ops
from repro_torch.obs.registry import (Counter, Gauge, Histogram,
                                      MetricsRegistry, Stopwatch, percentile)
from repro_torch.obs.runmeta import run_metadata
from repro_torch.obs.trace import EVENTS, LaneTracer, Tracer
from repro_torch.obs.uncertainty import UncertaintyTelemetry

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "Stopwatch",
    "percentile",
    "Tracer", "LaneTracer", "EVENTS",
    "OpProfiler", "profile_ops",
    "UncertaintyTelemetry",
    "run_metadata",
]
