"""PFP serving: uncertainty-aware decoding on top of ``models/lm.py``.

Counterpart of ``repro/serving/decode.py``. The PFP serve step gives each
new token's logit means and variances in one pass, which allows at decode
time what sampling-based BNNs need 30 and more passes for:

  * epistemic abstention: abstain (or escalate) when the mutual
    information of the next-token distribution is over a threshold;
  * variance-aware sampling: sample logits l ~ N(mu, sigma^2) (paper
    Eq. 11), then the token.

The reference runs its serve and prefill steps with
``compute_dtype=bfloat16``; the port has no ``compute_dtype`` and stays in
IEEE fp32, because the Eq. 12 variance is a small difference of two large
sums that reduced precision would cancel away (ROADMAP.md).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.bayes.metrics import predictive_metrics_from_samples
from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import DeviceLike
from repro_torch.core.gaussian import is_gaussian
from repro_torch.core.modes import Mode
from repro_torch.models import lm
from repro_torch.nn.module import Context


class DecodeOutput(NamedTuple):
    token: torch.Tensor        # (B,) sampled or argmax next token
    mutual_info: torch.Tensor  # (B,) epistemic uncertainty (MI)
    total_unc: torch.Tensor    # (B,) total predictive entropy
    abstain: torch.Tensor      # (B,) bool: MI over the threshold
    logit_mean: torch.Tensor
    logit_var: torch.Tensor


def uncertainty_decode(logit_mean, logit_var,
                       generator: Optional[torch.Generator] = None, *,
                       num_uncertainty_samples: int = 32,
                       mi_threshold: float = 0.5, greedy: bool = True,
                       eps: Optional[torch.Tensor] = None) -> DecodeOutput:
    """logit_mean / logit_var: (B, T, V) PFP outputs; the last position is
    the new token. Eq. 11 draws ``num_uncertainty_samples`` logit samples
    with noise from ``generator`` (on the logits' device), or takes the
    noise ``eps`` (N, B, V) as given, so that two implementations can be
    fed the same draws."""
    mean = logit_mean[:, -1]
    var = torch.clamp(logit_var[:, -1], min=0.0)
    std = torch.sqrt(var)
    if eps is None:
        eps = torch.randn((num_uncertainty_samples,) + tuple(mean.shape),
                          generator=generator, dtype=mean.dtype,
                          device=mean.device)
    samples = mean + eps.to(mean) * std                  # paper Eq. 11
    m = predictive_metrics_from_samples(samples)
    if greedy:
        token = torch.argmax(mean, dim=-1)
    else:
        one = mean + torch.randn(mean.shape, generator=generator,
                                 dtype=mean.dtype, device=mean.device) * std
        token = torch.multinomial(torch.softmax(one, dim=-1), 1,
                                  generator=generator)[:, 0]
    return DecodeOutput(token=token, mutual_info=m["mi"],
                        total_unc=m["total"], abstain=m["mi"] > mi_threshold,
                        logit_mean=mean, logit_var=var)


def _moments(logits):
    if is_gaussian(logits):
        return logits.mean, logits.var
    return logits, torch.zeros_like(logits)


def make_serve_step(cfg: ModelConfig, *, mode: Mode = Mode.PFP,
                    attention_mode: str = "mean_field",
                    formulation: str = "srm", impl: Optional[str] = None,
                    device: DeviceLike = None):
    """Returns ``serve_step(model, inputs, states) -> ((mean, var),
    new_states)``: one decode step against the decode state. ``impl``
    selects the operator implementation ('eager' | 'kernel' | None for the
    registry's default)."""
    ctx = Context(mode=mode, attention_mode=attention_mode,
                  formulation=formulation, impl=impl, device=device)

    def serve_step(model, inputs, states):
        logits, new_states = lm.decode_step(model, cfg, inputs, states, ctx)
        return _moments(logits), new_states

    return serve_step


def make_prefill_step(cfg: ModelConfig, max_len: int, *,
                      mode: Mode = Mode.PFP, formulation: str = "srm",
                      impl: Optional[str] = None, device: DeviceLike = None):
    """Returns ``prefill_step(model, inputs) -> ((mean, var), states)``:
    the last position's logits and a contiguous cache of ``max_len``
    rows."""
    ctx = Context(mode=mode, formulation=formulation, impl=impl,
                  device=device)

    def prefill_step(model, inputs):
        last, states = lm.prefill(model, cfg, inputs, ctx, max_len)
        return _moments(last), states

    return prefill_step
