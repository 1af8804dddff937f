"""Uncertainty routing: serve, escalate, or abstain per decoded token.

Counterpart of ``repro/serving/engine/router.py``. The PFP serve step
hands the router a per-token mutual-information signal for free (one
analytic pass -> logit means AND variances -> MI). The router turns it
into a serving policy with two thresholds:

    MI <= mi_continue                  CONTINUE  serve the PFP token
    mi_continue < MI < mi_abstain      ESCALATE  run an N-sample SVI
                                                  second-opinion pass
    MI >= mi_abstain                   ABSTAIN   evict ("I don't know")

Escalation is the paper's SVI-vs-PFP ablation recast as a serving policy:
for the grey zone between "confident" and "hopeless", spend N sampled
forward passes (what every token would cost under an SVI server) to get a
reference MI and token. If the SVI second opinion is still uncertain
(``svi_mi_abstain``) the request abstains; otherwise the SVI token is
served. With ``escalate_samples <= 0`` the grey zone abstains. The
fallback replays the slot's last input window against its decode state;
every update to that state is out of place, so the pooled KV buffers are
never perturbed.

The second opinion's noise comes from a ``torch.Generator`` that the
caller seeds per (request, token) before the pass, and the N samples draw
from it in turn; or, in tests, from N ``Context.eps`` callables that hand
in the reference's own noise. SVI mode runs the plain torch ops (no
kernel), as the reference's runs outside Pallas. On a mesh DTensor's own
propagation carries them (the KV caches per rank, ``core/mesh_route.py``);
each rank draws every leaf's noise whole from the seeded generator and
keeps its block (``Context.sample_eps``), and reads the logits whole, so
every rank reaches the same second opinion.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Optional, Sequence, Union

import torch

from repro_torch.bayes.metrics import predictive_metrics_from_samples
from repro_torch.configs.base import ModelConfig
from repro_torch.core import mesh_route
from repro_torch.core.gaussian import is_gaussian
from repro_torch.core.modes import Mode
from repro_torch.models import lm
from repro_torch.nn.module import Context

# A second opinion's noise: a generator the N samples draw from in turn,
# or N ``Context.eps`` callables, one a sample.
Noise = Union[torch.Generator, Sequence[Callable[[torch.Tensor],
                                                 torch.Tensor]]]


class Decision(enum.Enum):
    CONTINUE = "continue"
    ESCALATE = "escalate"
    ABSTAIN = "abstain"


# Process-global cache of second-opinion programs, keyed by (variant, cfg,
# samples, formulation, impl). The port compiles nothing, so an entry is a
# plain callable; the same key returns the same object, as the
# reference's cache of jitted programs does.
_FALLBACK_CACHE: dict = {}


def svi_fallback_cache_clear() -> None:
    """Drop the cached second-opinion programs (tests)."""
    _FALLBACK_CACHE.clear()


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


def _model_device(model) -> torch.device:
    return next(model.parameters()).device


def make_svi_fallback(cfg: ModelConfig, num_samples: int, *,
                      formulation: str = "srm", impl: Optional[str] = None):
    """N-sample SVI second-opinion pass.

    fallback(model, inputs, sub_state, noise, out_idx) -> (token, mi),
    two 0-d tensors: replays the decode inputs ``num_samples`` times with
    reparameterised weight samples (Mode.SVI draws sigma from the converted
    (mu, srm) leaves) against ``sub_state`` and reduces each sample's
    logits at position ``out_idx`` (the last *real* token of the replayed
    inputs) to a predicted token and mutual information. The state update
    is discarded. ``noise``: a generator the samples draw from in turn, or
    ``num_samples`` ``Context.eps`` callables.

    One callable per (cfg, samples, formulation, impl): repeated calls
    return the SAME object."""
    cache_key = ("seq", cfg, num_samples, formulation, impl)
    if cache_key in _FALLBACK_CACHE:
        return _FALLBACK_CACHE[cache_key]

    def fallback(model, inputs, sub_state, noise: Noise, out_idx: int):
        device = _model_device(model)
        generator = noise if isinstance(noise, torch.Generator) else None
        rows = []
        for j in range(num_samples):
            ctx = Context(mode=Mode.SVI, formulation=formulation, impl=impl,
                          device=device, generator=generator,
                          eps=None if generator is not None else noise[j])
            logits, _ = lm.decode_step(model, cfg, inputs, sub_state, ctx)
            if is_gaussian(logits):
                logits = logits.mean
            logits = mesh_route.full(logits)
            rows.append(logits[:, out_idx].float())          # (1, V)
        m = predictive_metrics_from_samples(torch.stack(rows))  # (N, 1, V)
        return m["pred"][0], m["mi"][0]

    _FALLBACK_CACHE[cache_key] = fallback
    return fallback


def make_svi_fallback_batched(cfg: ModelConfig, num_samples: int, *,
                              formulation: str = "srm",
                              impl: Optional[str] = None):
    """SLOT-BATCHED N-sample SVI second opinion (paged pools).

    batched(model, inputs, states, noise_for, uids, tok_idx, out_idx) ->
    (tokens (B,), mis (B,)) tensors, B = len(uids): ``inputs`` maps each
    escalating row r to its own replay inputs — (1, w) tokens and
    positions, (1,) cache_len, its (1, P) page-table row — all against ONE
    shared page pool; row r's noise is ``noise_for(uids[r], tok_idx[r])``,
    fetched just before its samples (the schedule-invariant
    per-(request, token) keying). Each row runs
    :func:`make_svi_fallback`'s program at the sequential shape: every row
    samples its own weights, so stacking rows would save no weight
    traffic, and one program makes a row's (token, mi) the sequential
    second opinion's bit for bit. Rows not in ``inputs`` are skipped and
    read 0.

    One callable per (cfg, samples, formulation, impl)."""
    cache_key = ("batched", cfg, num_samples, formulation, impl)
    if cache_key in _FALLBACK_CACHE:
        return _FALLBACK_CACHE[cache_key]
    one = make_svi_fallback(cfg, num_samples, formulation=formulation,
                            impl=impl)

    def batched(model, inputs, states, noise_for, uids, tok_idx, out_idx):
        device = _model_device(model)
        tokens = torch.zeros(len(uids), dtype=torch.long, device=device)
        mis = torch.zeros(len(uids), dtype=torch.float32, device=device)
        for r, row in inputs.items():
            tokens[r], mis[r] = one(model, row, states,
                                    noise_for(int(uids[r]), int(tok_idx[r])),
                                    int(out_idx[r]))
        return tokens, mis

    _FALLBACK_CACHE[cache_key] = batched
    return batched


class UncertaintyRouter:
    def __init__(self, cfg: ModelConfig,
                 config: RouterConfig = RouterConfig(), *,
                 formulation: str = "srm", impl: Optional[str] = None):
        self.config = config
        self.svi_mi_abstain = (config.svi_mi_abstain
                               if config.svi_mi_abstain is not None
                               else config.mi_abstain)
        self._fallback_key = (cfg, config.escalate_samples, formulation, impl)
        self._fallback = make_svi_fallback(
            cfg, config.escalate_samples, formulation=formulation, impl=impl)
        self._fallback_batched = None  # built on first batched escalation

    def route(self, mi: float) -> Decision:
        if mi <= self.config.mi_continue:
            return Decision.CONTINUE
        if mi >= self.config.mi_abstain or self.config.escalate_samples <= 0:
            return Decision.ABSTAIN
        return Decision.ESCALATE

    def second_opinion(self, model, inputs, sub_state, noise: Noise,
                       out_idx: Optional[int] = None):
        """(token, mi) from the SVI fallback. ``out_idx`` defaults to the
        last position of ``inputs``."""
        if out_idx is None:
            out_idx = len(inputs["tokens"][0]) - 1
        return self._fallback(model, inputs, sub_state, noise, out_idx)

    def second_opinion_batched(self, model, inputs, states, noise_for, uids,
                               tok_idx, out_idx):
        """(tokens (B,), mis (B,)): every escalating slot's second opinion
        against the shared page pool in one call. Row r is
        ``second_opinion`` for slot r bit for bit (the same program at the
        same shape, the same per-(request, token) noise)."""
        cfg, samples, formulation, impl = self._fallback_key
        if self._fallback_batched is None:
            self._fallback_batched = make_svi_fallback_batched(
                cfg, samples, formulation=formulation, impl=impl)
        return self._fallback_batched(model, inputs, states, noise_for, uids,
                                      tok_idx, out_idx)
