"""Persistent per-op schedule cache and the process-global tuning runtime.

Counterpart of ``repro/tuning/cache.py``. The cache maps ``(op,
shape_key, dtype, backend)`` to the winning
:class:`~repro_torch.tuning.schedules.Schedule`; ``core/dispatch.py``
consults the process-global instance through :func:`lookup`. A miss
returns None, and the caller then runs what it runs without a tuned
schedule (for ``norm_dense_act``: the unfused chain).

A corrupt, stale-versioned or malformed cache file gives a
``ScheduleCacheWarning`` and leaves the cache empty; it never raises into
a model forward. The file format is the reference's version 2, so either
package can read the other's file; the port writes no calibration fits.

:func:`record_shapes` captures every query made while a forward runs;
``autotune`` drives one forward under it to find a model's shape set.
:func:`consult_digest` says which schedules the latest consults found.
"""
from __future__ import annotations

import contextlib
import functools
import json
import os
import warnings
from typing import Dict, List, Mapping, Optional, Tuple

from repro_torch.tuning.schedules import Schedule, shape_key_str

CACHE_VERSION = 2
DEFAULT_CACHE_ENV = "REPRO_TORCH_SCHEDULE_CACHE"

ShapeKey = Tuple[int, ...]
Query = Tuple[str, ShapeKey, str, str]  # (op, shape_key, dtype, backend)


class ScheduleCacheWarning(UserWarning):
    """A schedule-cache file could not be used; the cache stays empty."""


def cache_key(op: str, shape_key: ShapeKey, dtype: str, backend: str) -> str:
    return f"{op}|{shape_key_str(shape_key)}|{dtype}|{backend}"


class ScheduleCache:
    """In-memory schedule store with JSON save/load. Each schedule may carry
    ``meta``: how it was chosen (mode, measured seconds, device name, when)."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._entries: Dict[str, Schedule] = {}
        self._meta: Dict[str, dict] = {}

    def get(self, op: str, shape_key: ShapeKey, dtype: str,
            backend: str) -> Optional[Schedule]:
        return self._entries.get(cache_key(op, shape_key, dtype, backend))

    def put(self, op: str, shape_key: ShapeKey, dtype: str, backend: str,
            schedule: Schedule, meta: Optional[Mapping] = None) -> None:
        if schedule.op != op:
            raise ValueError(f"schedule for op {schedule.op!r} stored under "
                             f"op {op!r}")
        key = cache_key(op, shape_key, dtype, backend)
        self._entries[key] = schedule
        if meta is not None:
            self._meta[key] = dict(meta)

    def get_meta(self, op: str, shape_key: ShapeKey, dtype: str,
                 backend: str) -> Optional[dict]:
        return self._meta.get(cache_key(op, shape_key, dtype, backend))

    def clear(self) -> None:
        self._entries.clear()
        self._meta.clear()

    def __len__(self) -> int:
        return len(self._entries)

    def entries(self) -> Dict[str, Schedule]:
        return dict(self._entries)

    def save(self, path: Optional[str] = None) -> str:
        """Write this cache's entries to ``path`` atomically (temp file +
        rename), so a reader never sees a torn file."""
        path = path or self.path
        if path is None:
            raise ValueError("no cache path given")
        payload = {
            "version": CACHE_VERSION,
            "entries": {
                k: {"schedule": s.to_json(), "meta": self._meta.get(k)}
                for k, s in self._entries.items()
            },
            "calibration": {},
        }
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as fh:
            json.dump(payload, fh, indent=2, sort_keys=True)
        os.replace(tmp, path)
        self.path = path
        return path

    def load(self, path: Optional[str] = None) -> "ScheduleCache":
        """Add the entries of ``path``; an entry of the file replaces one
        at the same key. A missing file adds nothing; a corrupt or stale
        one warns and adds nothing."""
        path = path or self.path
        if path is None:
            raise ValueError("no cache path given")
        self.path = path
        if not os.path.exists(path):
            return self
        try:
            with open(path) as fh:
                payload = json.load(fh)
        except (OSError, UnicodeDecodeError, json.JSONDecodeError) as e:
            warnings.warn(f"schedule cache {path!r} is unreadable ({e}); "
                          "no tuned schedules loaded", ScheduleCacheWarning)
            return self
        if (not isinstance(payload, dict)
                or not isinstance(payload.get("entries"), dict)):
            warnings.warn(f"schedule cache {path!r} is malformed; no tuned "
                          "schedules loaded", ScheduleCacheWarning)
            return self
        version = payload.get("version")
        if version != CACHE_VERSION:
            warnings.warn(f"schedule cache {path!r} has stale version "
                          f"{version!r} (want {CACHE_VERSION}); ignoring it "
                          "- re-run autotune to regenerate",
                          ScheduleCacheWarning)
            return self
        bad = 0
        for key, entry in payload["entries"].items():
            try:
                schedule = Schedule.from_json(entry["schedule"])
                meta = entry.get("meta")
                self._entries[str(key)] = schedule
                if meta is not None:
                    self._meta[str(key)] = dict(meta)
            except (ValueError, KeyError, TypeError, AttributeError):
                bad += 1
        if bad:
            warnings.warn(f"schedule cache {path!r}: skipped {bad} malformed "
                          "entr(y/ies)", ScheduleCacheWarning)
        return self


# ---------------------------------------------------------------------------
# Process-global runtime: what core/dispatch.py consults
# ---------------------------------------------------------------------------
_GLOBAL_CACHE = ScheduleCache()
_RECORDERS: List[List[Query]] = []
_CONSULTS: Dict[str, str] = {}  # op -> describe() of the last schedule found
_COUNTERS: Dict[str, int] = {"consults": 0, "hits": 0, "misses": 0}


def global_cache() -> ScheduleCache:
    return _GLOBAL_CACHE


def load_global_cache(path: Optional[str] = None) -> ScheduleCache:
    """Load ``path`` (or ``$REPRO_TORCH_SCHEDULE_CACHE``) into the global
    cache."""
    path = path or os.environ.get(DEFAULT_CACHE_ENV)
    if path:
        _GLOBAL_CACHE.load(path)
    return _GLOBAL_CACHE


def reset_global_cache() -> None:
    _GLOBAL_CACHE.clear()
    _GLOBAL_CACHE.path = None
    _CONSULTS.clear()
    consult_counters(reset=True)


@functools.lru_cache(maxsize=None)
def _cuda_name(index: int) -> str:
    import torch
    return torch.cuda.get_device_name(index)


def default_backend(device=None) -> str:
    """The backend part of a cache key: the name of the card a tensor on
    ``device`` runs on (``torch.cuda.get_device_name``, e.g. ``'NVIDIA
    H100 80GB HBM3'``), or ``'cpu'``. ``device=None`` means the current
    card when there is one. Schedules are timed on one card, so they are
    keyed by its name, not by the word ``cuda``."""
    import torch
    if device is None:
        if not torch.cuda.is_available():
            return "cpu"
        device = torch.device("cuda")
    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return _cuda_name(index)


def lookup(op: str, shape_key: ShapeKey, dtype: str,
           backend: Optional[str] = None) -> Optional[Schedule]:
    """The dispatch-layer query: record it (under :func:`record_shapes`),
    consult the global cache, count it and note what was found. Returns
    None on a miss, and for an entry whose meta says ``fuse: false`` (the
    tuner found the unfused chain faster at that shape): the caller then
    runs what it runs without a tuned schedule."""
    backend = backend or default_backend()
    shape_key = tuple(int(d) for d in shape_key)
    query: Query = (op, shape_key, str(dtype), backend)
    for rec in _RECORDERS:
        rec.append(query)
    schedule = _GLOBAL_CACHE.get(*query)
    if schedule is not None and \
            (_GLOBAL_CACHE.get_meta(*query) or {}).get("fuse") is False:
        schedule = None
    _CONSULTS[op] = schedule.describe() if schedule is not None else "default"
    _COUNTERS["consults"] += 1
    _COUNTERS["hits" if schedule is not None else "misses"] += 1
    return schedule


@contextlib.contextmanager
def record_shapes():
    """Capture every schedule query made inside the block. Yields a list of
    (op, shape_key, dtype, backend) tuples in call order, duplicates
    included (``autotune`` removes them)."""
    rec: List[Query] = []
    _RECORDERS.append(rec)
    try:
        yield rec
    finally:
        _RECORDERS.remove(rec)


def consults_snapshot(reset: bool = False) -> Dict[str, str]:
    """op -> describe() or 'default' for every consult since the last
    reset."""
    snap = dict(_CONSULTS)
    if reset:
        _CONSULTS.clear()
    return snap


def consult_counters(reset: bool = False) -> Dict[str, int]:
    """Total consults, hits and misses seen by :func:`lookup` since the
    last reset."""
    snap = dict(_COUNTERS)
    if reset:
        for key in _COUNTERS:
            _COUNTERS[key] = 0
    return snap


def consult_digest(reset: bool = False) -> str:
    """';'-joined summary of the last schedule found per op, e.g.
    ``norm_dense_act[bm=64/bn=64]`` or ``norm_dense_act:default``."""
    snap = consults_snapshot(reset=reset)
    return ";".join(snap[op] if snap[op] != "default" else f"{op}:default"
                    for op in sorted(snap))
