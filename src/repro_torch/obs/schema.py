"""Dependency-free JSON-schema subset validator and the trace / metrics
schemas that ``repro_torch.obs.validate`` checks exports against.

Counterpart of ``repro/obs/schema.py``. Supports the subset the schemas
below need: ``type`` (with the JSON names, including "integer" vs
"number"), ``required``, ``properties``, ``items``, ``enum``,
``minimum``, and ``additionalProperties: false``. ``validate`` returns a
list of human-readable error strings (empty = valid) instead of raising,
so the CLI can report every problem at once. The metrics payload's
``meta`` holds the port's run provenance (``runmeta.run_metadata``) in
place of the reference's JAX versions and interpret flag.
"""
from __future__ import annotations

from typing import Any, List

from repro_torch.obs.trace import EVENTS

_TYPES = {
    "object": dict,
    "array": list,
    "string": str,
    "boolean": bool,
    "null": type(None),
}


def _type_ok(value: Any, name: str) -> bool:
    if name == "integer":
        return isinstance(value, int) and not isinstance(value, bool)
    if name == "number":
        return (isinstance(value, (int, float))
                and not isinstance(value, bool))
    return isinstance(value, _TYPES[name])


def validate(obj: Any, schema: dict, path: str = "$") -> List[str]:
    """Validate ``obj`` against the schema subset; returns error strings
    (empty list = valid)."""
    errs: List[str] = []
    t = schema.get("type")
    if t is not None:
        names = t if isinstance(t, list) else [t]
        if not any(_type_ok(obj, n) for n in names):
            return [f"{path}: expected {'/'.join(names)}, "
                    f"got {type(obj).__name__}"]
    if "enum" in schema and obj not in schema["enum"]:
        errs.append(f"{path}: {obj!r} not in enum")
    if "minimum" in schema and isinstance(obj, (int, float)) \
            and not isinstance(obj, bool) and obj < schema["minimum"]:
        errs.append(f"{path}: {obj} < minimum {schema['minimum']}")
    if isinstance(obj, dict):
        props = schema.get("properties", {})
        for key in schema.get("required", ()):
            if key not in obj:
                errs.append(f"{path}: missing required key {key!r}")
        for key, sub in props.items():
            if key in obj:
                errs.extend(validate(obj[key], sub, f"{path}.{key}"))
        if schema.get("additionalProperties") is False:
            for key in obj:
                if key not in props:
                    errs.append(f"{path}: unexpected key {key!r}")
    if isinstance(obj, list) and "items" in schema:
        for i, item in enumerate(obj):
            errs.extend(validate(item, schema["items"], f"{path}[{i}]"))
    return errs


# One trace event (a JSONL line). Payload fields are event-specific, so
# additionalProperties stays open; the deterministic key set is pinned.
TRACE_EVENT_SCHEMA = {
    "type": "object",
    "required": ["step", "seq", "lane", "event"],
    "properties": {
        "step": {"type": "integer", "minimum": 0},
        "seq": {"type": "integer", "minimum": 0},
        "lane": {"type": "string"},
        "event": {"type": "string", "enum": list(EVENTS)},
        "uid": {"type": "integer"},
        "wall": {"type": "number", "minimum": 0},
    },
}

# One registry family inside a metrics snapshot.
_FAMILY_SCHEMA = {
    "type": "object",
    "required": ["type", "help", "values"],
    "properties": {
        "type": {"type": "string",
                 "enum": ["counter", "gauge", "histogram"]},
        "help": {"type": "string"},
        "values": {"type": "array", "items": {"type": "object"}},
    },
}

# The --metrics-out payload written by launch/serve.py.
METRICS_SCHEMA = {
    "type": "object",
    "required": ["meta", "summary", "registries"],
    "properties": {
        "meta": {
            "type": "object",
            "required": ["git_sha", "device_kind", "backend",
                         "torch_version", "cuda_version", "power_limit",
                         "tf32_off"],
            "properties": {
                "git_sha": {"type": "string"},
                "device_kind": {"type": "string"},
                "backend": {"type": "string", "enum": ["cuda", "cpu"]},
                "torch_version": {"type": "string"},
                "cuda_version": {"type": "string"},
                "power_limit": {"type": "string"},
                "tf32_off": {"type": "boolean"},
            },
        },
        "summary": {"type": "object"},
        "registries": {"type": "object"},
        "op_profile": {"type": "object"},
    },
}


def validate_metrics_payload(payload: dict) -> List[str]:
    errs = validate(payload, METRICS_SCHEMA)
    if errs:
        return errs
    for lane, snap in payload["registries"].items():
        if not isinstance(snap, dict):
            errs.append(f"$.registries.{lane}: expected object")
            continue
        for name, fam in snap.items():
            errs.extend(validate(fam, _FAMILY_SCHEMA,
                                 f"$.registries.{lane}.{name}"))
    return errs


__all__ = ["validate", "validate_metrics_payload",
           "TRACE_EVENT_SCHEMA", "METRICS_SCHEMA"]
