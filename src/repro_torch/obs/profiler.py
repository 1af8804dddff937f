"""Opt-in per-op, per-impl timing at the dispatch registry.

Counterpart of ``repro/obs/profiler.py``. ``core/dispatch.py`` is the
single seam every PFP operator passes through, so one hook there covers
the whole model zoo under both impls:

    with profile_ops() as prof:
        engine.decode_fn(...)         # each registry call fenced and timed
    print(prof.format_table())

The port runs eagerly, so there is no tracing to switch off (the
reference profiles under ``jax.disable_jit()``). Every wrapped call on a
CUDA tensor is fenced on BOTH sides with ``torch.cuda.synchronize`` of
its device: the fence before ``t0`` drains work a previous op left in
flight (which would otherwise be billed to this op), the fence after
stops the clock only when this op's outputs exist. On the CPU the ops
run synchronously and nothing is fenced. The fences change timing only:
a profiled pass gives the bits of an unprofiled one, and runs far slower
on the card (one synchronize per op), so its times are a breakdown, not
a step time.

When no profiler is active the dispatch hook is a single ``is None``
check: the serving hot path never sees this module.

The profiler also counts tuning-cache consults, hits and misses (every
``_schedule_for`` lookup) and the einsum op's eager fallbacks, so a
profile shows whether tuned schedules were bound and whether the kernel
impl hid eager work.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Tuple

import torch

from repro_torch.core.gaussian import GaussianTensor


def _cuda_devices(tree, out: set) -> set:
    """The CUDA devices of every tensor in ``tree`` (tensors, Gaussian
    tensors, and lists / tuples / dicts of them). A pending fusion whose
    value is not computed yet is skipped, not forced: forcing it here
    would run its ops outside their own timed calls."""
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            out.add(tree.device)
    elif isinstance(tree, GaussianTensor):
        if getattr(tree, "_value", True) is not None:
            _cuda_devices(tree.mean, out)
    elif isinstance(tree, (list, tuple)):
        for item in tree:
            _cuda_devices(item, out)
    elif isinstance(tree, dict):
        for item in tree.values():
            _cuda_devices(item, out)
    return out


def _fence(devices) -> None:
    for device in devices:
        torch.cuda.synchronize(device)


class OpProfiler:
    """Accumulates (op, impl) -> calls / wall seconds, plus tuning-cache
    consult outcomes. Created via :func:`profile_ops`; read via
    ``table()`` / ``summary()`` / ``format_table()``."""

    def __init__(self):
        self.ops: Dict[Tuple[str, str], List] = {}  # (op, impl) -> [n, s]
        self.cache_consults = 0
        self.cache_hits = 0
        self.cache_misses = 0
        self.cache_by_op: Dict[str, List] = {}  # op -> [consults, hits]
        self.fallbacks: Dict[str, int] = {}  # label -> count

    # -- dispatch hooks -----------------------------------------------------
    def wrap(self, name: str, impl: str, fn):
        cell = self.ops.setdefault((name, impl), [0, 0.0])

        def timed(*args, **kwargs):
            devices = _cuda_devices((args, kwargs), set())
            _fence(devices)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            _fence(_cuda_devices(out, devices))
            cell[0] += 1
            cell[1] += time.perf_counter() - t0
            return out

        return timed

    def on_cache_consult(self, op: str, hit: bool) -> None:
        self.cache_consults += 1
        per = self.cache_by_op.setdefault(op, [0, 0])
        per[0] += 1
        if hit:
            self.cache_hits += 1
            per[1] += 1
        else:
            self.cache_misses += 1

    def on_fallback(self, label: str) -> None:
        """A kernel-impl call with no kernel that ran the eager formulation
        instead (a general einsum contraction). Counted per label so a
        'kernel impl' profile cannot silently hide eager work."""
        self.fallbacks[label] = self.fallbacks.get(label, 0) + 1

    # -- reduction ----------------------------------------------------------
    @property
    def total_seconds(self) -> float:
        return sum(s for _, s in self.ops.values())

    def table(self) -> List[dict]:
        """Per-(op, impl) rows sorted by total time descending — the
        Table-4 shape: op, impl, calls, total/mean time, share."""
        total = self.total_seconds
        rows = []
        for (op, impl), (n, s) in self.ops.items():
            rows.append({
                "op": op, "impl": impl, "calls": n,
                "total_s": s,
                "mean_us": s / n * 1e6 if n else 0.0,
                "frac": s / total if total > 0 else 0.0,
            })
        rows.sort(key=lambda r: (-r["total_s"], r["op"], r["impl"]))
        return rows

    def summary(self) -> dict:
        return {
            "total_s": self.total_seconds,
            "rows": self.table(),
            "cache_consults": self.cache_consults,
            "cache_hits": self.cache_hits,
            "cache_misses": self.cache_misses,
            "cache_by_op": {op: {"consults": c, "hits": h}
                            for op, (c, h) in sorted(
                                self.cache_by_op.items())},
            "fallbacks": dict(sorted(self.fallbacks.items())),
        }

    def format_table(self) -> str:
        """Human-readable per-layer breakdown (the paper's Table-4 look):
        one line per (op, impl) plus the tuning-cache consult line."""
        lines = [f"{'op':18s} {'impl':7s} {'calls':>6s} {'total_ms':>9s} "
                 f"{'mean_us':>9s} {'share':>6s}"]
        for r in self.table():
            lines.append(
                f"{r['op']:18s} {r['impl']:7s} {r['calls']:6d} "
                f"{r['total_s'] * 1e3:9.3f} {r['mean_us']:9.1f} "
                f"{r['frac'] * 100:5.1f}%")
        lines.append(
            f"tuning cache: {self.cache_consults} consults, "
            f"{self.cache_hits} hits, {self.cache_misses} misses")
        if self.fallbacks:
            parts = ", ".join(f"{k} x{n}"
                              for k, n in sorted(self.fallbacks.items()))
            lines.append(f"eager fallbacks: {parts}")
        return "\n".join(lines)


@contextlib.contextmanager
def profile_ops():
    """Activate per-op profiling on the dispatch registry for the
    duration; yields the :class:`OpProfiler`."""
    from repro_torch.core import dispatch

    prof = OpProfiler()
    prev = dispatch.set_profiler(prof)
    try:
        yield prof
    finally:
        dispatch.set_profiler(prev)


__all__ = ["OpProfiler", "profile_ops"]
