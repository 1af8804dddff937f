"""Uncertainty routing: serve or abstain per decoded token.

Counterpart of ``repro/serving/engine/router.py``, its routing half. The
PFP serve step hands the router a per-token mutual-information signal
for free (one analytic pass -> logit means AND variances -> MI). The
router turns it into a serving policy with two thresholds:

    MI <= mi_continue                  CONTINUE  serve the PFP token
    mi_continue < MI < mi_abstain      ESCALATE  an N-sample SVI second
                                                  opinion (reference)
    MI >= mi_abstain                   ABSTAIN   evict ("I don't know")

With ``escalate_samples <= 0`` the grey zone abstains, as in the
reference. The SVI second opinion (``make_svi_fallback``,
``make_svi_fallback_batched``, ``second_opinion*``) comes with port
slice 3b, part (b) (ROADMAP.md queue A item 2); until then a router
built with ``escalate_samples > 0`` raises instead of serving a PFP token
where the reference would serve the SVI one.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional

from repro_torch.configs.base import ModelConfig


class Decision(enum.Enum):
    CONTINUE = "continue"
    ESCALATE = "escalate"
    ABSTAIN = "abstain"


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    mi_continue: float = 0.5      # at or below: serve the PFP token
    mi_abstain: float = 2.0       # at or above: abstain immediately
    escalate_samples: int = 8     # SVI samples in the second-opinion pass
    svi_mi_abstain: Optional[float] = None  # default: mi_abstain
    ood_mi: Optional[float] = None  # OOD-alarm threshold for the
    #                                 uncertainty telemetry; default:
    #                                 mi_abstain (routing itself never
    #                                 reads this)


class UncertaintyRouter:
    def __init__(self, cfg: ModelConfig,
                 config: RouterConfig = RouterConfig(), *,
                 formulation: str = "srm", impl: Optional[str] = None):
        if config.escalate_samples > 0:
            raise NotImplementedError(
                "SVI escalation (escalate_samples > 0) comes with port "
                "slice 3b, part (b) (ROADMAP.md queue A item 2); build the "
                "router with escalate_samples=0, which abstains in the "
                "grey zone")
        self.config = config
        self.svi_mi_abstain = (config.svi_mi_abstain
                               if config.svi_mi_abstain is not None
                               else config.mi_abstain)
        self.formulation = formulation
        self.impl = impl

    def route(self, mi: float) -> Decision:
        if mi <= self.config.mi_continue:
            return Decision.CONTINUE
        if mi >= self.config.mi_abstain or self.config.escalate_samples <= 0:
            return Decision.ABSTAIN
        return Decision.ESCALATE
