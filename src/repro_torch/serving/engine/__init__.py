"""The port's continuous-batching serving engine (counterpart of
``repro/serving/engine/``): the ``Engine`` without SVI escalation and
speculative decoding, its scheduler, radix prefix index, routing policy,
metrics and load generator, over the two decode-state pools. Escalation
and speculation come with port slice 3b, part (b) (ROADMAP.md)."""
from repro_torch.serving.batcher import Request
from repro_torch.serving.engine.engine import Engine, EngineConfig
from repro_torch.serving.engine.loadgen import poisson_trace, run_load
from repro_torch.serving.engine.metrics import EngineMetrics, percentile
from repro_torch.serving.engine.prefix import PrefixIndex, PrefixNode
from repro_torch.serving.engine.router import (Decision, RouterConfig,
                                               UncertaintyRouter)
from repro_torch.serving.engine.scheduler import (RequestScheduler,
                                                  SchedulerConfig, pages_for)
from repro_torch.serving.engine.state import (DecodeStatePool,
                                              PagedDecodeStatePool)

__all__ = [
    "Engine", "EngineConfig", "Request",
    "RequestScheduler", "SchedulerConfig", "pages_for",
    "DecodeStatePool", "PagedDecodeStatePool",
    "PrefixIndex", "PrefixNode",
    "UncertaintyRouter", "RouterConfig", "Decision",
    "EngineMetrics", "percentile",
    "poisson_trace", "run_load",
]
