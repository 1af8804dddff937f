"""The port's continuous-batching serving engine (counterpart of
``repro/serving/engine/``): the ``Engine`` with SVI escalation and
uncertainty-speculative decoding, its scheduler, radix prefix index,
routing policy and SVI second opinion, metrics and load generator, over
the two decode-state pools. The reference's ``clear_shared_pass_cache``
has no counterpart: the port shares no compiled passes."""
from repro_torch.serving.batcher import Request
from repro_torch.serving.engine.engine import Engine, EngineConfig
from repro_torch.serving.engine.loadgen import poisson_trace, run_load
from repro_torch.serving.engine.metrics import EngineMetrics, percentile
from repro_torch.serving.engine.prefix import PrefixIndex, PrefixNode
from repro_torch.serving.engine.router import (Decision, RouterConfig,
                                               UncertaintyRouter,
                                               make_svi_fallback,
                                               make_svi_fallback_batched,
                                               svi_fallback_cache_clear)
from repro_torch.serving.engine.scheduler import (RequestScheduler,
                                                  SchedulerConfig, pages_for)
from repro_torch.serving.engine.state import (DecodeStatePool,
                                              PagedDecodeStatePool)

__all__ = [
    "Engine", "EngineConfig", "Request",
    "RequestScheduler", "SchedulerConfig", "pages_for",
    "DecodeStatePool", "PagedDecodeStatePool",
    "PrefixIndex", "PrefixNode",
    "UncertaintyRouter", "RouterConfig", "Decision", "make_svi_fallback",
    "make_svi_fallback_batched", "svi_fallback_cache_clear",
    "EngineMetrics", "percentile",
    "poisson_trace", "run_load",
]
