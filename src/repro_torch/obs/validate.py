"""CLI validator for observability exports.

Counterpart of ``repro/obs/validate.py``:

    PYTHONPATH=src python -m repro_torch.obs.validate \\
        --trace obs/trace.jsonl --metrics obs/metrics.json \\
        --prom obs/metrics.prom

Checks every trace event against TRACE_EVENT_SCHEMA, the metrics payload
against METRICS_SCHEMA (including each registry family), and that the
Prometheus text parses and is non-empty. Exits nonzero listing every
problem found.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List


def check_trace(path: str) -> List[str]:
    from repro_torch.obs.schema import TRACE_EVENT_SCHEMA, validate

    errs: List[str] = []
    n = 0
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            n += 1
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                errs.append(f"{path}:{lineno}: not JSON ({e})")
                continue
            for e in validate(rec, TRACE_EVENT_SCHEMA):
                errs.append(f"{path}:{lineno}: {e}")
    if n == 0:
        errs.append(f"{path}: empty trace")
    return errs


def check_metrics(path: str) -> List[str]:
    from repro_torch.obs.schema import validate_metrics_payload

    try:
        with open(path) as f:
            payload = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        return [f"{path}: unreadable ({e})"]
    return [f"{path}: {e}" for e in validate_metrics_payload(payload)]


def check_prom(path: str) -> List[str]:
    from repro_torch.obs.registry import parse_prometheus

    try:
        with open(path) as f:
            text = f.read()
    except OSError as e:
        return [f"{path}: unreadable ({e})"]
    try:
        metrics = parse_prometheus(text)
    except ValueError as e:
        return [f"{path}: {e}"]
    if not metrics:
        return [f"{path}: no samples"]
    return []


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trace", help="JSONL trace to validate")
    ap.add_argument("--metrics", help="metrics JSON payload to validate")
    ap.add_argument("--prom", help="Prometheus text export to validate")
    args = ap.parse_args(argv)
    if not (args.trace or args.metrics or args.prom):
        ap.error("nothing to validate")
    errs: List[str] = []
    if args.trace:
        errs.extend(check_trace(args.trace))
    if args.metrics:
        errs.extend(check_metrics(args.metrics))
    if args.prom:
        errs.extend(check_prom(args.prom))
    if errs:
        for e in errs:
            print(f"INVALID: {e}", file=sys.stderr)
        return 1
    checked = [p for p in (args.trace, args.metrics, args.prom) if p]
    print(f"OK: {', '.join(checked)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
