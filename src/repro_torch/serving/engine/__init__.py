"""The serving engine's decode-state pools (counterpart of
``repro/serving/engine/``). The continuous-batching ``Engine``, its
scheduler, prefix index, router, metrics and load generator come with a
later slice (ROADMAP.md)."""
from repro_torch.serving.engine.state import (DecodeStatePool,
                                              PagedDecodeStatePool)

__all__ = ["DecodeStatePool", "PagedDecodeStatePool"]
