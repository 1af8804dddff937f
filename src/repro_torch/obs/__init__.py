"""Observability for the port's serving stack (counterpart of
``repro/obs/``), all host-side bookkeeping:

  * ``registry`` — Counter / Gauge / Histogram metric families with label
    sets, a shared ``Stopwatch`` wall clock, and Prometheus text export;
    ``EngineMetrics`` is backed by one ``MetricsRegistry``;
  * ``trace`` — deterministic structured request tracing keyed on
    ``(engine_step, seq)``, exported as JSONL or Chrome trace-event JSON;
  * ``uncertainty`` — router-band occupancy, escalation-outcome counters,
    ECE-style calibration over the MI stream and a thresholded OOD alarm.

The reference's ``profiler``, ``schema``, ``validate`` and ``runmeta``
are not ported yet (ROADMAP.md).
"""
from repro_torch.obs.registry import (Counter, Gauge, Histogram,
                                      MetricsRegistry, Stopwatch, percentile)
from repro_torch.obs.trace import EVENTS, LaneTracer, Tracer
from repro_torch.obs.uncertainty import UncertaintyTelemetry

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "Stopwatch",
    "percentile",
    "Tracer", "LaneTracer", "EVENTS",
    "UncertaintyTelemetry",
]
