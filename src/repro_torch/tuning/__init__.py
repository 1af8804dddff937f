"""Schedule autotuning for the port's fused kernel (paper §6).

Counterpart of ``repro/tuning``. The dispatch registry
(``core/dispatch.py``) consults this package's process-global schedule
cache when the fusion pass meets a norm -> dense -> activation chain; a
hit runs the fused kernel at the cached tile, a miss the unfused chain.

  * :mod:`repro_torch.tuning.schedules` — :class:`Schedule` descriptors
  * :mod:`repro_torch.tuning.search`    — the legal tiles of a shape
  * :mod:`repro_torch.tuning.cache`     — persistent cache, shape recorder
  * :mod:`repro_torch.tuning.measure`   — checked, CUDA-event-timed tuner
  * :mod:`repro_torch.tuning.autotune`  — ``autotune(forward, ...)`` and
    the CLI; not imported here, so that ``python -m
    repro_torch.tuning.autotune`` runs it as a fresh module
"""
from repro_torch.tuning.cache import (ScheduleCache, ScheduleCacheWarning,
                                      consult_counters, consult_digest,
                                      default_backend, global_cache,
                                      load_global_cache, lookup,
                                      record_shapes, reset_global_cache)
from repro_torch.tuning.measure import TuneResult, tune_into_cache, tune_op
from repro_torch.tuning.schedules import (OP_BLOCK_NAMES, TUNABLE_OPS,
                                          Schedule)
from repro_torch.tuning.search import candidates

__all__ = [
    "Schedule", "ScheduleCache", "ScheduleCacheWarning", "TuneResult",
    "OP_BLOCK_NAMES", "TUNABLE_OPS",
    "candidates", "tune_op",
    "tune_into_cache", "lookup", "record_shapes", "consult_counters",
    "consult_digest", "default_backend", "global_cache",
    "load_global_cache", "reset_global_cache",
]
