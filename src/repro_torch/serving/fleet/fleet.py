"""The fleet frontend: R data-parallel replicas behind one admission
router.

Counterpart of ``repro/serving/fleet/fleet.py``. Each replica is a full
serving stack over its own page pool — a plain ``Engine``, or a
``DisaggPair`` (prefill/decode disaggregation) under
``FleetConfig.disaggregate``. The frontend owns nothing on the device: it
routes each submitted request to one replica (longest cached prefix
first, least-loaded fallback — see ``router.py``), ticks every replica
once per fleet step, and aggregates telemetry.

All replicas share ONE model (the same ``lm.LM``, the same
``UncertaintyRouter``) and the same engine config, so every pass in the
fleet has the shapes of the single-engine baseline's passes. A row's bits
depend only on its own tokens and keys (the kernels' row contracts, and
one shape a pass on the CPU), and the per-(uid, token) keyed sampling
makes placement invisible: the routed output is bit for bit the
baseline's.

With ``mesh=`` every replica serves on the same (data, model) mesh, as in
the reference: the fleet is replicated in time on every rank of it (each
rank's frontend routes the same way, on replicated host state), each
replica's passes run sharded across the mesh.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.obs.registry import Stopwatch
from repro_torch.obs.trace import Tracer
from repro_torch.serving.batcher import Request
from repro_torch.serving.engine.engine import (Engine, EngineConfig,
                                               placed_model)
from repro_torch.serving.engine.router import RouterConfig, UncertaintyRouter
from repro_torch.serving.engine.scheduler import (RequestScheduler,
                                                  SchedulerConfig)
from repro_torch.serving.fleet.handoff import DisaggPair
from repro_torch.serving.fleet.metrics import (FleetMetrics,
                                               pooled_handoff_gauges)
from repro_torch.serving.fleet.router import PrefixRouter


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    replicas: int = 2
    disaggregate: bool = False     # replicas are DisaggPairs, not Engines
    route_min_tokens: int = 1      # cached tokens needed for a prefix route

    def __post_init__(self):
        if self.replicas < 1:
            raise ValueError("a fleet needs at least one replica")
        if self.route_min_tokens < 1:
            raise ValueError("route_min_tokens must be >= 1")


class Fleet:
    """Same submit/step/now/idle/metrics protocol as ``Engine``, so the
    loadgen harness and serve CLI drive a fleet like a single engine.
    ``model`` is the port's ``lm.LM`` on ``device`` (None: the CUDA
    card); ``mesh``: a live ``DeviceMesh`` every replica serves on (from
    one copy of the model placed on it, ``placed_model``)."""

    def __init__(self, cfg: ModelConfig, model,
                 config: EngineConfig = EngineConfig(),
                 fleet_config: FleetConfig = FleetConfig(), *,
                 router: Optional[UncertaintyRouter] = None,
                 scheduler_config: Optional[SchedulerConfig] = None,
                 mesh=None, device: DeviceLike = None,
                 tracer: Optional[Tracer] = None):
        self.cfg = cfg
        self.config = config
        self.fleet_config = fleet_config
        device = resolve_device(device)
        model = placed_model(model, mesh)
        if router is None:
            router = UncertaintyRouter(cfg, RouterConfig(),
                                       formulation=config.formulation,
                                       impl=config.impl)
        sched_cfg = scheduler_config or SchedulerConfig()
        # One shared Tracer: the frontend emits on lane 'fleet', replica i
        # on lane 'r<i>' (a DisaggPair fans out to 'r<i>.prefill' /
        # 'r<i>.decode') — every lane shares one deterministic event
        # sequence, so two identical runs produce byte-identical traces.
        self._tracer = (tracer.bind("fleet") if isinstance(tracer, Tracer)
                        else None)
        self.replicas: List = []
        for i in range(fleet_config.replicas):
            if fleet_config.disaggregate:
                self.replicas.append(DisaggPair(
                    cfg, model, config, router=router,
                    scheduler_config=sched_cfg, mesh=mesh, device=device,
                    tracer=tracer, lane=f"r{i}"))
            else:
                self.replicas.append(Engine(
                    cfg, model, config, router=router,
                    scheduler=RequestScheduler(sched_cfg,
                                               max_len=config.max_len),
                    mesh=mesh, tracer=tracer, lane=f"r{i}", device=device))
        self.router = PrefixRouter(min_tokens=fleet_config.route_min_tokens)
        # ONE wall clock for the whole fleet: every replica engine's
        # metrics and the frontend's share it, so the pooled throughput
        # is exactly the sum of the per-replica throughputs.
        clock = Stopwatch()
        for r in self.replicas:
            for e in (r.engines if hasattr(r, "engines") else (r,)):
                e.metrics.set_clock(clock)
        pairs = (self.replicas if fleet_config.disaggregate else [])
        self.metrics = FleetMetrics(
            fleet_config.replicas,
            lambda: [r.metrics.summary() for r in self.replicas],
            (lambda: pooled_handoff_gauges(pairs)) if pairs else None,
            clock=clock)
        self.finished: List[Request] = []
        self._tick = 0

    # -- engine protocol ----------------------------------------------------
    @property
    def now(self) -> int:
        return self._tick

    @property
    def idle(self) -> bool:
        return all(r.idle for r in self.replicas)

    def submit(self, req: Request) -> bool:
        idx, matched, hit = self.router.route(req, self.replicas)
        if self._tracer is not None:
            # before the replica's own 'submit' event, so a request's
            # routing always precedes its admission in the trace
            self._tracer.emit(self._tick, "route_replica", uid=req.uid,
                              replica=idx, matched=matched, prefix_hit=hit)
        ok = self.replicas[idx].submit(req)
        self.metrics.on_route(idx, matched, hit, ok)
        return ok

    def step(self) -> None:
        for replica in self.replicas:
            replica.step()
            finished = replica.finished
            replica.finished = []
            self.finished.extend(finished)
        self.metrics.on_step(
            tuple(r.active_slots for r in self.replicas))
        self._tick += 1

    def run_until_idle(self, max_steps: int = 100_000) -> dict:
        while not self.idle:
            if self._tick >= max_steps:
                raise RuntimeError(f"fleet not idle after {max_steps} steps")
            self.step()
        return self.metrics.summary()
