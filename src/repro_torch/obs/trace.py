"""Deterministic structured request tracing.

Counterpart of ``repro/obs/trace.py`` (host-only Python; the port keeps
its own copy).

Every lifecycle event is a flat dict keyed on ``(step, seq)``:

  * ``step`` — the emitting engine's (or fleet frontend's) logical step
    counter at emission time. The engine clock is the ONLY time base; two
    identical runs therefore produce byte-identical traces.
  * ``seq`` — a per-tracer monotone sequence number breaking ties within
    a step (events of one step keep emission order).
  * ``lane`` — which component emitted it ("engine", "fleet", "r0",
    "r1.prefill", ...). A fleet shares ONE tracer across the frontend
    and every replica so a request's whole journey lands in one stream.
  * ``event`` — one of :data:`EVENTS`; ``uid`` where the event concerns
    one request; free-form payload fields otherwise.
  * ``wall`` — wall-clock seconds since tracer construction, attached
    only when the tracer was built with ``wall=True`` and ALWAYS
    strippable (``to_jsonl(strip_wall=True)``): determinism is the
    contract, wall time is an annotation.

Exports: JSONL (one event per line, sorted keys) and Chrome trace-event
JSON viewable in Perfetto / chrome://tracing — request lifetimes become
complete ("X") spans on a per-lane track, point events become instants.
The synthetic timeline maps one engine step to 1000 trace-µs so step
structure is readable regardless of real step duration.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional

EVENTS = (
    "submit",        # request offered to a scheduler (accepted flag)
    "expire",        # deadline-expired in the waiting room
    "admit",         # slot allocated (uid, slot, prefix pages/tokens)
    "prefill_round", # one (batched) prefill round (slots, tokens fed)
    "decode_step",   # one lockstep PFP decode / verify pass (active slots)
    "route",         # one routed token (uid, token, mi, decision)
    "escalate",      # SVI second opinion resolved (uid, pfp/svi mi, outcome)
    "spec_draft",    # mean-only draft pass (slots, drafted tokens)
    "spec_verify",   # chunked PFP verify pass (slots, accepted tokens)
    "cow",           # copy-on-write page duplication(s) for a slot
    "preempt",       # slot evicted mid-flight, request requeued
    "requeue_overflow",  # preemption requeue displaced a waiter
    "defrag",        # page pool defragmented
    "route_replica", # fleet frontend picked a replica (uid, replica, match)
    "handoff",       # disaggregated prefill->decode handoff (uid, ticks)
    "finish",        # request left the engine (uid, reason, tokens)
)


class Tracer:
    """Append-only event sink shared by every component of one serving
    stack. Host-side only: one small dict append per event; engines guard
    every call site with ``if tracer is not None`` so a disabled run pays
    nothing at all."""

    def __init__(self, wall: bool = False):
        self.events: List[dict] = []
        self._seq = 0
        self._wall = wall
        self._t0 = time.perf_counter() if wall else None

    def emit(self, lane: str, step: int, event: str,
             uid: Optional[int] = None, **fields) -> None:
        if event not in EVENTS:
            raise ValueError(f"unknown trace event {event!r}")
        rec = {"step": int(step), "seq": self._seq, "lane": lane,
               "event": event}
        if uid is not None:
            rec["uid"] = int(uid)
        rec.update(fields)
        if self._wall:
            rec["wall"] = time.perf_counter() - self._t0
        self._seq += 1
        self.events.append(rec)

    def bind(self, lane: str) -> "LaneTracer":
        """A view of this tracer that stamps ``lane`` on every event —
        what an engine holds, so fleet wiring is just handing each
        replica a differently-named view of one shared tracer."""
        return LaneTracer(self, lane)

    # -- export -------------------------------------------------------------
    def to_jsonl(self, strip_wall: bool = False) -> str:
        """One event per line, keys sorted — byte-identical across
        identical runs once ``strip_wall`` removes the only
        non-deterministic field."""
        lines = []
        for rec in self.events:
            if strip_wall and "wall" in rec:
                rec = {k: v for k, v in rec.items() if k != "wall"}
            lines.append(json.dumps(rec, sort_keys=True))
        return "\n".join(lines) + ("\n" if lines else "")

    def write_jsonl(self, path: str, strip_wall: bool = False) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            f.write(self.to_jsonl(strip_wall=strip_wall))

    def to_chrome(self) -> dict:
        """Chrome trace-event JSON (Perfetto-viewable).

        Per-request lifetimes (admit -> finish, per lane) become complete
        "X" spans; every other event becomes an instant. The timeline is
        synthetic and deterministic: 1 engine step = 1000 µs, seq breaks
        ties inside a step.
        """
        lanes: Dict[str, int] = {}

        def pid(lane: str) -> int:
            if lane not in lanes:
                lanes[lane] = len(lanes) + 1
            return lanes[lane]

        def ts(rec: dict) -> int:
            return rec["step"] * 1000 + (rec["seq"] % 1000)

        out = []
        open_spans: Dict[tuple, dict] = {}
        for rec in self.events:
            p = pid(rec["lane"])
            if rec["event"] == "admit":
                open_spans[(rec["lane"], rec.get("uid"))] = rec
                continue
            if rec["event"] == "finish":
                start = open_spans.pop((rec["lane"], rec.get("uid")), None)
                if start is not None:
                    out.append({
                        "name": f"req {rec.get('uid')}",
                        "cat": "request", "ph": "X",
                        "pid": p, "tid": rec.get("uid", 0),
                        "ts": ts(start),
                        "dur": max(ts(rec) - ts(start), 1),
                        "args": {"reason": rec.get("reason"),
                                 "tokens": rec.get("tokens")},
                    })
                continue
            args = {k: v for k, v in rec.items()
                    if k not in ("step", "seq", "lane", "event", "uid",
                                 "wall")}
            out.append({
                "name": rec["event"], "cat": "engine", "ph": "i", "s": "t",
                "pid": p, "tid": rec.get("uid", 0), "ts": ts(rec),
                "args": args,
            })
        # spans never closed (still in flight when the trace was cut)
        for (lane, uid), start in sorted(open_spans.items(),
                                         key=lambda kv: kv[1]["seq"]):
            out.append({
                "name": f"req {uid}", "cat": "request", "ph": "X",
                "pid": lanes[lane], "tid": uid or 0, "ts": ts(start),
                "dur": 1, "args": {"reason": "unfinished"},
            })
        meta = [{"name": "process_name", "ph": "M", "pid": i,
                 "args": {"name": lane}}
                for lane, i in sorted(lanes.items(), key=lambda kv: kv[1])]
        return {"traceEvents": meta + out, "displayTimeUnit": "ms"}

    def write_chrome(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f, sort_keys=True)


class LaneTracer:
    """A lane-stamping view of a shared :class:`Tracer` (see ``bind``)."""

    __slots__ = ("_tracer", "lane")

    def __init__(self, tracer: Tracer, lane: str):
        self._tracer = tracer
        self.lane = lane

    def emit(self, step: int, event: str, uid: Optional[int] = None,
             **fields) -> None:
        self._tracer.emit(self.lane, step, event, uid=uid, **fields)


__all__ = ["Tracer", "LaneTracer", "EVENTS"]
