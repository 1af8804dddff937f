"""Uncertainty telemetry over the serve-time MI stream.

Counterpart of ``repro/obs/uncertainty.py`` (host-only Python; the port
keeps its own copy).

The engine's mutual-information signal is the product the paper sells
(one analytic pass -> calibrated uncertainty); this module is the audit
trail that makes it operable:

  * **router-band occupancy** — how many routed tokens landed in each
    band (CONTINUE / ESCALATE / ABSTAIN), as a labeled counter plus a
    streaming MI histogram (log-spaced buckets, so both the confident
    mass near 0 and the abstain tail resolve);
  * **escalation outcomes** — of the tokens the router escalated, how
    many the SVI second opinion cleared vs abstained, and how often the
    SVI token AGREED with the PFP argmax;
  * **ECE-style calibration** — at every escalation the stack computes
    both the cheap signal (PFP MI) and a sampled reference (the SVI
    token), so escalations double as free calibration audits: PFP
    confidence ``exp(-MI)`` is binned and compared against the observed
    PFP-vs-SVI agreement rate per bin. The expected calibration error
    over those bins is reported as ``mi_ece`` — 0 when confidence
    tracks agreement, large when the MI signal is mis-scaled;
  * **OOD alarm** — a thresholded counter over the raw MI stream
    (default threshold: the router's abstain bound). A burst of alarms
    is the serve-time symptom of an out-of-distribution prompt mix.

Pure host bookkeeping on numbers the engine already computed — no extra
device passes, ever.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.obs.registry import MetricsRegistry

# Log-spaced MI buckets (nats): resolves both near-zero confident mass
# and the heavy escalate/abstain tail.
MI_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.0, 4.0,
              8.0, 16.0)
_CAL_BINS = 10  # confidence bins for the ECE estimate


class UncertaintyTelemetry:
    """Per-engine uncertainty monitors, backed by the owning
    ``EngineMetrics``'s registry (so they export with everything else)."""

    def __init__(self, registry: MetricsRegistry,
                 ood_mi: Optional[float] = None):
        self._bands = registry.counter(
            "router_band_tokens", "routed tokens per router band",
            labelnames=("band",))
        self._mi_hist = registry.histogram(
            "mi_nats", MI_BUCKETS, "mutual information per routed token")
        self._ood = registry.counter(
            "ood_alarms", "routed tokens with MI at/above the OOD threshold")
        self._esc_outcome = registry.counter(
            "escalation_outcomes", "SVI second-opinion results",
            labelnames=("outcome",))
        self._esc_agree = registry.counter(
            "escalation_agreements", "escalations where SVI confirmed the "
            "PFP token")
        self.ood_mi = ood_mi
        # confidence-bin -> [count, agreements, confidence mass]
        self._cal = [[0, 0, 0.0] for _ in range(_CAL_BINS)]

    def set_ood_threshold(self, ood_mi: float) -> None:
        self.ood_mi = ood_mi

    # -- events -------------------------------------------------------------
    def on_decision(self, mi: float, band: str) -> None:
        """One routed token: its MI and the router's FIRST decision
        (the raw band, before any SVI resolution)."""
        self._bands.labels(band=band).inc()
        self._mi_hist.observe(mi)
        if self.ood_mi is not None and mi >= self.ood_mi:
            self._ood.inc()

    def on_escalation_outcome(self, pfp_mi: float, pfp_token: int,
                              svi_mi: float, svi_token: int,
                              outcome: str) -> None:
        """One resolved escalation: the PFP signal that triggered it, the
        SVI reference, and the final band ('continue'/'abstain')."""
        self._esc_outcome.labels(outcome=outcome).inc()
        agreed = int(pfp_token) == int(svi_token)
        if agreed:
            self._esc_agree.inc()
        # Calibration audit: confidence from the cheap signal vs observed
        # agreement with the sampled reference.
        conf = _confidence(pfp_mi)
        b = min(_CAL_BINS - 1, int(conf * _CAL_BINS))
        cell = self._cal[b]
        cell[0] += 1
        cell[1] += agreed
        cell[2] += conf

    # -- reduction ----------------------------------------------------------
    def ece(self) -> float:
        """Expected calibration error over the escalation audits: the
        count-weighted mean |agreement_rate - mean_confidence| per bin.
        0.0 with no audits."""
        total = sum(c for c, _, _ in self._cal)
        if total == 0:
            return 0.0
        err = 0.0
        for count, agree, conf_sum in self._cal:
            if count == 0:
                continue
            err += count / total * abs(agree / count - conf_sum / count)
        return err

    def summary(self) -> dict:
        esc_cont = self._esc_outcome.labels(outcome="continue").value
        esc_abst = self._esc_outcome.labels(outcome="abstain").value
        audits = esc_cont + esc_abst
        hist = self._mi_hist._solo()
        return {
            "band_continue": self._bands.labels(band="continue").value,
            "band_escalate": self._bands.labels(band="escalate").value,
            "band_abstain": self._bands.labels(band="abstain").value,
            "ood_alarms": self._ood.value,
            "escalate_continue": esc_cont,
            "escalate_abstain": esc_abst,
            "svi_agreement_rate": (self._esc_agree.value / max(audits, 1)),
            "mi_ece": self.ece(),
            "mi_mean": hist.sum / max(hist.total, 1),
            "mi_p50": hist.quantile(50),
            "mi_p99": hist.quantile(99),
        }


def _confidence(mi: float) -> float:
    """Map an MI (nats, >= 0) to a [0, 1] confidence: exp(-MI). Exact for
    a two-point predictive split and monotone everywhere — good enough
    for binning; the ECE monitor needs ordering, not sharpness."""
    import math
    return math.exp(-max(mi, 0.0))


__all__ = ["UncertaintyTelemetry", "MI_BUCKETS"]
