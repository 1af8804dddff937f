"""Schedule measurement: pick the best candidate for one (op, shape).

Counterpart of ``repro/tuning/measure.py``, for ``norm_dense_act``. Two
modes, chosen by the device:

  * ``time`` (a CUDA card): every candidate is first run against the
    unfused kernel chain on the same inputs (norm kernel, ``to_srm``,
    dense kernel, activation kernel); a candidate that disagrees is
    dropped and named. The survivors and the chain itself are timed with
    CUDA events (median of ``ITERS`` calls) and the fastest candidate
    wins. Fusing is worth it only where the winner beats the chain: the
    result says whether it does (``fuse``), and the cache stores that, so
    the fusion pass runs the chain where it is faster;
  * ``rank`` (the CPU, where the plain version runs and a time says
    nothing of the card): the first legal candidate wins, nothing is
    timed, and the unit fuses.
"""
from __future__ import annotations

import dataclasses
import statistics
import time
import zlib
from typing import Dict, List, Optional

import torch

from repro_torch.kernels import ops
from repro_torch.tuning import search
from repro_torch.tuning.schedules import Schedule
from repro_torch.tuning.search import ShapeKey

ITERS = 5  # timed calls per candidate; the median counts
# A candidate must agree with the unfused chain to within the dense
# kernel's tolerance (tests/test_kernels.py); csrc/pfp_fused.cu is built
# to agree bit for bit, and the records say whether it did.
CHECK_TOL = dict(rtol=1e-5, atol=1e-4)


@dataclasses.dataclass
class TuneResult:
    op: str
    shape_key: ShapeKey
    dtype: str
    mode: str
    best: Schedule
    records: List[Dict]   # one per candidate kept, best first
    dropped: List[Dict]   # candidates that failed the check
    unfused_s: Optional[float] = None  # the chain's time (time mode)

    @property
    def fuse(self) -> bool:
        """Whether the fused unit should run: the best candidate beats the
        unfused chain (always, where nothing was timed)."""
        return self.unfused_s is None or \
            self.records[0]["seconds"] < self.unfused_s


def default_mode(device) -> str:
    return "time" if torch.device(device).type == "cuda" else "rank"


def make_inputs(op: str, shape_key: ShapeKey, device, dtype="float32"):
    """Deterministic inputs of the fused unit at ``shape_key`` (rmsnorm of
    a VAR input; silu is the tuner's activation, the LM gate's): (mu, var,
    gain, bias None, mu_w, srm_w). The seed is a crc32 of (op, shape), so
    two tuning runs time the same numbers."""
    if op != "norm_dense_act":
        raise ValueError(f"unknown tunable op {op!r}")
    m, k, n = shape_key
    g = torch.Generator().manual_seed(
        zlib.crc32(repr((op, tuple(shape_key))).encode()))
    dt = getattr(torch, dtype)

    def draw(*shape, positive=False, scale=1.0):
        a = scale * torch.randn(shape, generator=g)
        if positive:
            a = torch.nn.functional.softplus(a)
        return a.to(device=device, dtype=dt)

    mu, var, gain = draw(m, k), draw(m, k, positive=True), 1.0 + draw(k)
    mu_w = draw(k, n, scale=0.1)
    srm_w = draw(k, n, positive=True, scale=0.1) + mu_w * mu_w
    return mu, var, gain, None, mu_w, srm_w


def unfused_chain(mu, second, gain, bias, mu_w, srm_w, *,
                  norm: str = "rmsnorm", rep: str = "var", eps: float = 1e-6,
                  act: str = "silu"):
    """The unfused kernel chain the fused unit replaces, on the wrappers
    of ``kernels/ops.py``: the norm, ``to_srm`` as the registry forms it
    (second + square(mean)), the dense, the activation. (mean, srm)."""
    if norm == "rmsnorm":
        h_mu, h_var = ops.pfp_rmsnorm(mu, second, gain, rep=rep, eps=eps)
    else:
        h_mu, h_var = ops.pfp_layernorm(mu, second, gain, bias, rep=rep,
                                        eps=eps)
    y_mu, y_var = ops.pfp_dense(h_mu, h_var + torch.square(h_mu), mu_w,
                                srm_w)
    return ops.pfp_activation(y_mu, y_var, kind=act)


def time_seconds(fn) -> float:
    """Median seconds of ``ITERS`` calls of ``fn`` after one warm-up call,
    each call between two CUDA events."""
    fn()
    times = []
    for _ in range(ITERS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3)
    return float(statistics.median(times))


def tune_op(op: str, shape_key: ShapeKey, dtype: str = "float32", *,
            device="cpu", limit: int = 8) -> TuneResult:
    """Search the candidates for one (op, shape, dtype) on ``device`` and
    return the winner with its records (best first) and, on a card, the
    unfused chain's time. Raises if every candidate failed the check."""
    mode = default_mode(device)
    shape_key = tuple(int(d) for d in shape_key)
    cands = search.candidates(op, shape_key, limit=limit)
    if not cands:
        raise ValueError(f"{op} does not fuse at {shape_key}: the unfused "
                         f"chain's dense splits K there")
    if mode == "rank":
        records = [{"schedule": c.describe(), "blocks": c.as_dict(),
                    "seconds": None} for c in cands]
        return TuneResult(op, shape_key, dtype, mode, cands[0], records, [])
    args = make_inputs(op, shape_key, device, dtype)
    want = unfused_chain(*args)
    records, dropped, kept = [], [], []
    for cand in cands:
        got = ops.pfp_norm_dense_act(*args, schedule=cand)
        err = max(float((g - r).abs().max()) for g, r in zip(got, want))
        rec = {"schedule": cand.describe(), "blocks": cand.as_dict(),
               "bitwise": all(torch.equal(g, r) for g, r in zip(got, want)),
               "max_abs_diff": err, "seconds": None}
        if not all(torch.allclose(g, r, **CHECK_TOL)
                   for g, r in zip(got, want)):
            dropped.append(rec)
            continue
        rec["seconds"] = time_seconds(
            lambda: ops.pfp_norm_dense_act(*args, schedule=cand))
        records.append(rec)
        kept.append(cand)
    if not kept:
        raise RuntimeError(f"every {op} candidate at {shape_key} disagrees "
                           f"with the unfused chain: {dropped}")
    unfused_s = time_seconds(lambda: unfused_chain(*args))
    order = sorted(range(len(kept)), key=lambda i: records[i]["seconds"])
    return TuneResult(op, shape_key, dtype, mode, kept[order[0]],
                      [records[i] for i in order], dropped, unfused_s)


def tune_into_cache(cache, op: str, shape_key: ShapeKey, dtype: str,
                    backend: str, *, device="cpu",
                    limit: int = 8) -> TuneResult:
    """One tuner step against a ``ScheduleCache``: search (and measure),
    then store the winner with how it was chosen. Where the unfused chain
    was faster, the entry's meta says ``fuse: false`` and the fusion pass
    treats it as a miss (``cache.lookup``)."""
    result = tune_op(op, shape_key, dtype, device=device, limit=limit)
    meta = {
        "mode": result.mode,
        "measured_s": result.records[0]["seconds"],
        "unfused_s": result.unfused_s,
        "fuse": result.fuse,
        "device_kind": backend,
        "candidates": [r["schedule"] for r in result.records],
        "dropped": [r["schedule"] for r in result.dropped],
        "tuned_at": time.time(),
    }
    cache.put(op, result.shape_key, dtype, backend, result.best, meta=meta)
    return result
