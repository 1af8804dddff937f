"""Prefill/decode disaggregation over one shared page pool.

Counterpart of ``repro/serving/fleet/handoff.py``. A ``DisaggPair`` is one
fleet replica split into two engines that share a single
``PagedDecodeStatePool`` and a single ``PrefixIndex``:

  * the PREFILL engine receives a shadow copy of every request
    (``prefill_only=True``, ``max_new_tokens=0``, uid offset by
    ``SHADOW_UID_BASE``) and runs the normal chunked, batched prefill.
    When the shadow finishes, ``Engine._finish`` registers the whole
    prompt's lineage in the shared prefix index — the index takes
    refcounted ``hold``s on the filled pages, which is the handoff: the
    pages now outlive the prefill slot;
  * the DECODE engine then admits the real request. Its admission path
    prefix-matches ``len(prompt) - 1`` tokens against the shared index,
    ``share``s the held pages into its slot table at refcount+1, and
    prefills exactly ONE token (the last prompt token — next-token
    logits come from feeding it). A long prompt therefore costs the
    decode engine one chunk regardless of prompt length: decode
    admission never waits behind a peer's prefill.

Safety of the shared pool: the two engines allocate slots from the same
free list, so each engine's lockstep passes see the peer's slots as
inactive rows — their ``cache_len`` sits at their position, so the paged
cache insert redirects every such write to the trash page, and page
refcounts + copy-on-write prevent aliasing. Preemption (``_make_room``)
only ever victimizes the preempting engine's own slots.

Escalation replays over the shared pool: each engine keeps its own
``_prev_states`` snapshot (a reference to the pool's state tensors from
before its last decode step). The peer's steps in between write the pool
out of place, so the snapshot is untouched, and a replay reads only the
escalating slot's own pages (its table row), which no peer writes: the
replay is a function of the request's tokens and position alone, as on a
single engine. A defrag would move pages under the peer's snapshot,
hence the refusal of ``auto_defrag`` below.

Determinism: the real request decodes under its ORIGINAL uid, so the
per-(uid, token) keyed uncertainty sampling produces bit-for-bit the
tokens and MI traces of a single undisaggregated engine. The only device
work disaggregation adds is one copy-on-write of the boundary page when
the prompt is not page-aligned.

With ``mesh=`` the shared pool is placed once on the mesh (the
decode-state rules) and both engines take it.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.obs.trace import Tracer
from repro_torch.serving.batcher import Request
from repro_torch.serving.engine.engine import (Engine, EngineConfig,
                                               check_mesh_family,
                                               placed_model)
from repro_torch.serving.engine.metrics import percentile
from repro_torch.serving.engine.prefix import PrefixIndex
from repro_torch.serving.engine.router import RouterConfig, UncertaintyRouter
from repro_torch.serving.engine.scheduler import (RequestScheduler,
                                                  SchedulerConfig)
from repro_torch.serving.engine.state import PagedDecodeStatePool

# Shadow prefill requests live in the same pool as the real ones (unique
# owner uids are a pool invariant), so their uids are offset far past any
# real uid space.
SHADOW_UID_BASE = 1 << 40


class _PairMetricsView:
    """Duck-typed ``metrics`` for the loadgen protocol (summary only)."""

    def __init__(self, pair: "DisaggPair"):
        self._pair = pair

    def summary(self) -> dict:
        return self._pair.summary()


class DisaggPair:
    """One disaggregated replica: prefill engine + decode engine sharing
    a page pool and a prefix index. Implements the same submit/step/now/
    idle/metrics protocol as ``Engine``, so loadgen and the fleet
    frontend drive either interchangeably. ``model`` is the port's
    ``lm.LM`` on ``device`` (None: the CUDA card); ``mesh``: a live
    ``DeviceMesh`` both engines serve on, from one placed copy of the
    model (``placed_model``) and over one placed pool."""

    def __init__(self, cfg: ModelConfig, model,
                 config: EngineConfig = EngineConfig(), *,
                 router: Optional[UncertaintyRouter] = None,
                 scheduler_config: Optional[SchedulerConfig] = None,
                 mesh=None, device: DeviceLike = None,
                 tracer: Optional[Tracer] = None, lane: str = "pair"):
        if config.page_size is None:
            raise ValueError("disaggregation requires the paged Gaussian "
                             "KV-cache (set page_size)")
        if not config.prefix_sharing:
            raise ValueError("disaggregation hands pages from prefill to "
                             "decode through the prefix index (set "
                             "prefix_sharing=True)")
        if config.auto_defrag:
            raise ValueError(
                "auto_defrag is unsupported on a disaggregated shared "
                "pool: a defrag inside one engine's step would remap the "
                "PEER engine's page tables without permuting its "
                "escalation-replay snapshot")
        self.config = config
        device = resolve_device(device)
        if mesh is not None:
            check_mesh_family(cfg)
        model = placed_model(model, mesh)
        pool = PagedDecodeStatePool(
            cfg, config.slots, config.max_len, config.page_size,
            num_pages=config.page_budget, mesh=mesh, device=device)
        retention = (config.prefix_retention_pages
                     if config.prefix_retention_pages is not None
                     else pool.total_pages)
        prefix = PrefixIndex(config.page_size, retention)
        # ONE remap registration for the shared index (the engines are
        # constructed with prefix= and never register their own).
        pool.add_remap_listener(prefix.remap_pages)
        self.pool = pool
        self.prefix = prefix
        if router is None:
            router = UncertaintyRouter(cfg, RouterConfig(),
                                       formulation=config.formulation,
                                       impl=config.impl)
        sched_cfg = scheduler_config or SchedulerConfig()
        # The engines trace on their own sub-lanes of the pair's lane;
        # the pair itself emits only the handoff instants.
        self._tracer = (tracer.bind(lane) if isinstance(tracer, Tracer)
                        else None)
        self.prefill_engine = Engine(
            cfg, model, config, router=router,
            scheduler=RequestScheduler(sched_cfg, max_len=config.max_len),
            pool=pool, prefix=prefix, mesh=mesh, tracer=tracer,
            lane=lane + ".prefill", device=device)
        self.decode_engine = Engine(
            cfg, model, config, router=router,
            scheduler=RequestScheduler(sched_cfg, max_len=config.max_len),
            pool=pool, prefix=prefix, mesh=mesh, tracer=tracer,
            lane=lane + ".decode", device=device)
        self.finished: List[Request] = []
        self.metrics = _PairMetricsView(self)
        self._submitted = 0   # real requests offered to the pair
        self._rejected = 0    # refused at pair admission
        # shadow uid -> the real request awaiting its pages
        self._pending: Dict[int, Request] = {}
        # real uid -> pair tick its shadow prefill finished (handoff t0)
        self._shadow_done: Dict[int, int] = {}
        # reason -> real requests finished by their shadow's failure
        # (expired in the prefill queue, displaced by requeue overflow)
        self._inherited: Dict[str, int] = {}
        self._deferred: List[Request] = []  # decode waiting room was full
        self.handoff_latencies: List[float] = []  # decode admit - shadow done
        self._rec_i = 0                     # decode records already scanned
        # per-tick evidence that prefill never blocks decode: ticks where
        # the decode engine served tokens WHILE the prefill engine was
        # mid-prompt on peer requests
        self.overlap_steps = 0
        self.step_trace: List[tuple] = []   # (prefilling, decode tokens)
        self._tick = 0

    # -- engine protocol -----------------------------------------------------
    @property
    def now(self) -> int:
        return self._tick

    @property
    def engines(self):
        """The pair's member engines (fleet wiring: shared-clock and
        telemetry fan-out over every engine a replica holds)."""
        return (self.prefill_engine, self.decode_engine)

    @property
    def active_slots(self) -> int:
        return (self.prefill_engine.active_slots
                + self.decode_engine.active_slots)

    @property
    def load(self) -> int:
        return (self.prefill_engine.load + self.decode_engine.load
                + len(self._deferred))

    def prefix_peek(self, tokens) -> int:
        return self.decode_engine.prefix_peek(tokens)

    @property
    def idle(self) -> bool:
        return (not self._pending and not self._deferred
                and self.prefill_engine.idle and self.decode_engine.idle)

    def submit(self, req: Request) -> bool:
        """Admit ``req`` into the pair: a shadow prefill-only copy enters
        the prefill engine now; the real request enters the decode engine
        when the shadow's pages are in the index. False = rejected."""
        self._submitted += 1
        # The decode engine's feasibility checks, applied up front — a
        # request that could never decode must not burn prefill work.
        if len(req.prompt) == 0 or \
                len(req.prompt) + req.max_new_tokens > self.config.max_len:
            self._rejected += 1
            return False
        shadow = Request(
            uid=SHADOW_UID_BASE + req.uid, prompt=req.prompt,
            max_new_tokens=0, priority=req.priority, deadline=req.deadline,
            arrival=req.arrival, prefill_only=True)
        if not self.prefill_engine.submit(shadow):
            self._rejected += 1
            return False
        self._pending[shadow.uid] = req
        return True

    def _drain(self, engine: Engine) -> List[Request]:
        out = engine.finished
        engine.finished = []
        return out

    def _handoff(self, req: Request) -> None:
        if not self.decode_engine.submit(req):
            self._deferred.append(req)  # waiting room full; retry next tick

    def step(self) -> None:
        self.prefill_engine.step()
        for shadow in self._drain(self.prefill_engine):
            req = self._pending.pop(shadow.uid, None)
            if req is None:
                continue
            if shadow.finish_reason == "prefill":
                self._shadow_done[req.uid] = self._tick
                self._handoff(req)
            else:
                # the shadow never produced pages (expired in the queue,
                # displaced by a requeue overflow): the real request
                # inherits its outcome
                req.finish(shadow.finish_reason)
                self._inherited[shadow.finish_reason] = \
                    self._inherited.get(shadow.finish_reason, 0) + 1
                self.finished.append(req)
        if self._deferred:
            deferred, self._deferred = self._deferred, []
            for req in deferred:
                self._handoff(req)
        prefilling = self.prefill_engine.prefilling
        tokens_before = self.decode_engine.metrics.tokens_generated
        self.decode_engine.step()
        served = self.decode_engine.metrics.tokens_generated - tokens_before
        if prefilling > 0 and served > 0:
            self.overlap_steps += 1
        self.step_trace.append((prefilling, served))
        self.finished.extend(self._drain(self.decode_engine))
        # handoff latency (in pair ticks): decode admission - shadow
        # finish, read off the decode engine's per-request records
        records = self.decode_engine.metrics.records
        for rec in records[self._rec_i:]:
            done = self._shadow_done.pop(rec.uid, None)
            if done is not None:
                ticks = rec.admit_step - done
                self.handoff_latencies.append(ticks)
                if self._tracer is not None:
                    self._tracer.emit(self._tick, "handoff", uid=rec.uid,
                                      ticks=ticks)
        self._rec_i = len(records)
        self._tick += 1

    # -- reduction -----------------------------------------------------------
    _SUM_KEYS = (
        "escalations", "tokens_generated", "prefill_tokens",
        "preemptions", "requeue_overflow", "prefix_hits", "prefix_misses",
        "prefix_shared_pages", "prefill_tokens_saved", "cow_copies",
        "decode_passes", "verify_passes", "draft_passes", "svi_passes",
        # uncertainty telemetry sums too (shadows never decode, so the
        # prefill engine contributes zeros — summing keeps the key set
        # uniform with the fleet reduction)
        "band_continue", "band_escalate", "band_abstain", "ood_alarms",
        "escalate_continue", "escalate_abstain",
    )

    def summary(self) -> dict:
        """Pair-level summary: the decode engine's view of the request
        stream (finished/latency/abstain stats — shadows would skew
        them), summed WORK counters from both engines, and the
        disaggregation gauges."""
        pre = self.prefill_engine.metrics.summary()
        dec = self.decode_engine.metrics.summary()
        out = dict(dec)
        for k in self._SUM_KEYS:
            out[k] = pre[k] + dec[k]
        out["prefix_hit_rate"] = out["prefix_hits"] / max(
            out["prefix_hits"] + out["prefix_misses"], 1)
        # real requests whose shadow failed finish at the pair boundary
        # (they never reach the decode engine's records)
        out["finished"] = dec["finished"] + sum(self._inherited.values())
        out["expired"] = dec["expired"] + self._inherited.get("expired", 0)
        # submitted/rejected count REAL requests at the pair boundary —
        # the engine-level counters double-count shadows and deferred
        # handoff retries.
        out["submitted"] = self._submitted
        out["rejected"] = self._rejected
        out["steps"] = self._tick
        out["final_occupancy"] = self.active_slots
        out["prefill_engine_prefill_tokens"] = pre["prefill_tokens"]
        out["decode_engine_prefill_tokens"] = dec["prefill_tokens"]
        out["handoffs"] = len(self.handoff_latencies)
        out["p50_handoff_steps"] = percentile(self.handoff_latencies, 50)
        out["p99_handoff_steps"] = percentile(self.handoff_latencies, 99)
        out["decode_steps_during_peer_prefill"] = self.overlap_steps
        return out
