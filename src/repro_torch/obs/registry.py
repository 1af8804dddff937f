"""Unified metric primitives: Counter / Gauge / Histogram families with
label sets, one registry per telemetry owner, Prometheus text export.

Counterpart of ``repro/obs/registry.py`` (host-only Python; the port
keeps its own copy).

Design constraints, in order:

  * zero device-path cost — every operation is a Python int/float update
    on the host; the registry is never consulted inside a device pass;
  * deterministic snapshots — ``snapshot()`` contains no wall-clock
    unless the owner explicitly published one, and label sets serialize
    in sorted order, so two identical runs produce identical snapshots;
  * one wall clock per run — ``Stopwatch`` is shared between a fleet
    frontend and its replicas (first start wins, ``frozen()`` pins one
    reading across a whole reduction), which is what makes the pooled
    fleet throughput exactly equal the sum of the per-replica
    throughputs instead of disagreeing by per-replica start skew.

Histogram bucket semantics are Prometheus's: ``bounds`` are upper bounds,
a sample lands in the first bucket with ``value <= bound`` (inclusive),
and the exported ``le`` counts are cumulative with a final ``+Inf``.
"""
from __future__ import annotations

import contextlib
import math
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple


def percentile(xs: Sequence[float], q: float) -> float:
    """Classic nearest-rank percentile (q in [0, 100]); 0.0 on empty."""
    if not xs:
        return 0.0
    s = sorted(xs)
    idx = min(len(s) - 1, max(0, math.ceil(q / 100.0 * len(s)) - 1))
    return float(s[idx])


class Stopwatch:
    """A lazily-started wall clock shared by every metrics owner in one
    run. ``start()`` is first-wins (a fleet frontend and its replicas all
    call it; the earliest event anchors the run); ``frozen()`` pins one
    reading so a multi-owner reduction sees a single consistent elapsed
    value."""

    def __init__(self):
        self._t0: Optional[float] = None
        self._pinned: Optional[float] = None

    @property
    def started(self) -> bool:
        return self._t0 is not None

    def start(self) -> None:
        if self._t0 is None:
            self._t0 = time.perf_counter()

    def elapsed(self) -> float:
        if self._t0 is None:
            return 0.0
        if self._pinned is not None:
            return self._pinned
        return time.perf_counter() - self._t0

    @contextlib.contextmanager
    def frozen(self):
        """Pin ``elapsed()`` for the duration (re-entrant: inner freezes
        keep the outermost pin)."""
        outer = self._pinned
        if outer is None:
            self._pinned = self.elapsed()
        try:
            yield self
        finally:
            self._pinned = outer


# ---------------------------------------------------------------------------
# Metric children (one per label-value combination)
# ---------------------------------------------------------------------------
class Counter:
    """Monotone event count."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError("counters only go up")
        self.value += n


class Gauge:
    """Last-set value with running peak."""

    __slots__ = ("value", "peak")

    def __init__(self):
        self.value = 0.0
        self.peak = 0.0

    def set(self, v: float) -> None:
        self.value = v
        self.peak = max(self.peak, v)

    def inc(self, n: float = 1.0) -> None:
        self.set(self.value + n)

    def dec(self, n: float = 1.0) -> None:
        self.value -= n


class Histogram:
    """Fixed-bucket streaming histogram (Prometheus semantics).

    ``bounds`` are inclusive upper bounds; a sample lands in the first
    bucket with ``value <= bound``, or the implicit ``+Inf`` overflow
    bucket. ``quantile(q)`` is a bucket-resolution estimate (upper bound
    of the bucket holding the q-quantile) — good enough for the MI-stream
    p50/p99 gauges without retaining samples.
    """

    __slots__ = ("bounds", "counts", "overflow", "total", "sum")

    def __init__(self, bounds: Sequence[float]):
        b = tuple(float(x) for x in bounds)
        if list(b) != sorted(b) or len(set(b)) != len(b):
            raise ValueError("histogram bounds must be strictly increasing")
        self.bounds = b
        self.counts = [0] * len(b)
        self.overflow = 0
        self.total = 0
        self.sum = 0.0

    def observe(self, value: float) -> None:
        self.total += 1
        self.sum += value
        for i, bound in enumerate(self.bounds):
            if value <= bound:
                self.counts[i] += 1
                return
        self.overflow += 1

    def cumulative(self) -> List[Tuple[float, int]]:
        """[(le, cumulative_count), ...] ending with (+Inf, total)."""
        out, running = [], 0
        for bound, c in zip(self.bounds, self.counts):
            running += c
            out.append((bound, running))
        out.append((math.inf, self.total))
        return out

    def quantile(self, q: float) -> float:
        """Upper bound of the bucket containing the q-quantile (q in
        [0, 100]); 0.0 on empty, last finite bound on overflow."""
        if self.total == 0:
            return 0.0
        rank = max(1, math.ceil(q / 100.0 * self.total))
        running = 0
        for bound, c in zip(self.bounds, self.counts):
            running += c
            if running >= rank:
                return bound
        return self.bounds[-1] if self.bounds else 0.0


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class _Family:
    """One named metric family: the set of children keyed by label
    values. A label-less family proxies inc/set/observe to its single
    child, so ``registry.counter("steps").inc()`` reads naturally."""

    def __init__(self, name: str, kind: str, help: str,
                 labelnames: Tuple[str, ...], **kwargs):
        self.name = name
        self.kind = kind
        self.help = help
        self.labelnames = labelnames
        self._kwargs = kwargs
        self._children: Dict[Tuple[str, ...], object] = {}
        if not labelnames:
            self._children[()] = _KINDS[kind](**kwargs)

    def labels(self, **labelvalues):
        if set(labelvalues) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, "
                f"got {tuple(labelvalues)}")
        key = tuple(str(labelvalues[k]) for k in self.labelnames)
        child = self._children.get(key)
        if child is None:
            child = self._children[key] = _KINDS[self.kind](**self._kwargs)
        return child

    def _solo(self):
        if self.labelnames:
            raise ValueError(f"{self.name} is labeled; call .labels() first")
        return self._children[()]

    # label-less proxies
    def inc(self, n=1):
        self._solo().inc(n)

    def dec(self, n=1):
        self._solo().dec(n)

    def set(self, v):
        self._solo().set(v)

    def observe(self, v):
        self._solo().observe(v)

    @property
    def value(self):
        return self._solo().value

    def children(self) -> Iterable[Tuple[Tuple[str, ...], object]]:
        return sorted(self._children.items())


class MetricsRegistry:
    """A flat namespace of metric families owned by one telemetry object
    (an engine, a fleet frontend). Factory methods are idempotent: asking
    for an existing name returns the existing family (kind must match)."""

    def __init__(self):
        self._families: Dict[str, _Family] = {}

    def _make(self, name: str, kind: str, help: str,
              labelnames: Tuple[str, ...], **kwargs) -> _Family:
        fam = self._families.get(name)
        if fam is not None:
            if fam.kind != kind:
                raise ValueError(
                    f"{name} already registered as a {fam.kind}")
            return fam
        fam = _Family(name, kind, help, labelnames, **kwargs)
        self._families[name] = fam
        return fam

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> _Family:
        return self._make(name, "counter", help, tuple(labelnames))

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> _Family:
        return self._make(name, "gauge", help, tuple(labelnames))

    def histogram(self, name: str, bounds: Sequence[float], help: str = "",
                  labelnames: Sequence[str] = ()) -> _Family:
        return self._make(name, "histogram", help, tuple(labelnames),
                          bounds=bounds)

    def get(self, name: str) -> Optional[_Family]:
        return self._families.get(name)

    # -- export -------------------------------------------------------------
    def snapshot(self) -> dict:
        """Deterministic nested-dict dump (JSON-ready): families in sorted
        name order, children in sorted label order."""
        out = {}
        for name in sorted(self._families):
            fam = self._families[name]
            values = []
            for key, child in fam.children():
                labels = dict(zip(fam.labelnames, key))
                if fam.kind == "histogram":
                    values.append({
                        "labels": labels,
                        "buckets": [[("+Inf" if math.isinf(le) else le), c]
                                    for le, c in child.cumulative()],
                        "sum": child.sum, "count": child.total,
                    })
                elif fam.kind == "gauge":
                    values.append({"labels": labels, "value": child.value,
                                   "peak": child.peak})
                else:
                    values.append({"labels": labels, "value": child.value})
            out[name] = {"type": fam.kind, "help": fam.help,
                         "values": values}
        return out

    def to_prometheus(self, extra_labels: Optional[Dict[str, str]] = None,
                      prefix: str = "repro_") -> str:
        """Prometheus text exposition format (version 0.0.4)."""
        extra = dict(extra_labels or {})

        def fmt_labels(labels: Dict[str, str]) -> str:
            merged = {**extra, **labels}
            if not merged:
                return ""
            inner = ",".join(f'{k}="{_escape(v)}"'
                             for k, v in sorted(merged.items()))
            return "{" + inner + "}"

        lines = []
        for name in sorted(self._families):
            fam = self._families[name]
            full = prefix + name
            if fam.help:
                lines.append(f"# HELP {full} {fam.help}")
            lines.append(f"# TYPE {full} {fam.kind}")
            for key, child in fam.children():
                labels = dict(zip(fam.labelnames, key))
                if fam.kind == "histogram":
                    for le, c in child.cumulative():
                        le_s = "+Inf" if math.isinf(le) else _num(le)
                        lines.append(
                            f"{full}_bucket"
                            f"{fmt_labels({**labels, 'le': le_s})} {c}")
                    lines.append(f"{full}_sum{fmt_labels(labels)} "
                                 f"{_num(child.sum)}")
                    lines.append(f"{full}_count{fmt_labels(labels)} "
                                 f"{child.total}")
                else:
                    lines.append(f"{full}{fmt_labels(labels)} "
                                 f"{_num(child.value)}")
        return "\n".join(lines) + "\n"


def _escape(v: str) -> str:
    return str(v).replace("\\", r"\\").replace('"', r"\"").replace(
        "\n", r"\n")


def _num(v) -> str:
    if isinstance(v, bool):
        return str(int(v))
    if isinstance(v, int):
        return str(v)
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def parse_prometheus(text: str) -> Dict[str, Dict[str, float]]:
    """Minimal parser for the text exposition format (the CI smoke's
    "does the export parse" check — not a full client library). Returns
    {metric_name: {serialized_labels: value}}; raises ValueError on a
    malformed sample line."""
    out: Dict[str, Dict[str, float]] = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        try:
            head, value = line.rsplit(" ", 1)
            if "{" in head:
                name, rest = head.split("{", 1)
                if not rest.endswith("}"):
                    raise ValueError("unterminated label set")
                labels = rest[:-1]
            else:
                name, labels = head, ""
            if not name or any(c.isspace() for c in name):
                raise ValueError("bad metric name")
            val = float(value)
        except ValueError as e:
            raise ValueError(f"line {lineno}: {e}: {line!r}") from None
        out.setdefault(name, {})[labels] = val
    return out


__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "Stopwatch",
    "percentile", "parse_prometheus",
]
