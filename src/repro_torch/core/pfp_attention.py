"""Mean-field PFP attention (counterpart of ``repro/core/pfp_attention.py``).

The attention probabilities A come from the score means (optionally
probit-corrected by the score variances) and are treated as deterministic,
so the output is an affine map of V:

    E[out] = A @ mu_v,    Var[out] = A^2 @ var_v
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import pfp_math
from repro_torch.core.gaussian import VAR, GaussianTensor, as_gaussian

MEAN_FIELD = "mean_field"
VARIANCE_CORRECTED = "variance_corrected"


def pfp_attention_weights(q: GaussianTensor, k: GaussianTensor, scale: float,
                          mask: Optional[torch.Tensor] = None,
                          mode: str = MEAN_FIELD) -> torch.Tensor:
    """Attention probabilities from Gaussian Q/K, shape (B, H, Tq, Tk)."""
    scores = torch.einsum("bhqd,bhkd->bhqk", q.mean, k.mean) * scale
    if mode == VARIANCE_CORRECTED:
        qv, kv = q.var, k.var
        score_var = (torch.einsum("bhqd,bhkd->bhqk", qv, kv)
                     + torch.einsum("bhqd,bhkd->bhqk", qv, torch.square(k.mean))
                     + torch.einsum("bhqd,bhkd->bhqk", torch.square(q.mean), kv)
                     ) * (scale * scale)
        scores = pfp_math.probit_corrected_logits(scores, score_var)
    elif mode != MEAN_FIELD:
        raise ValueError(f"unknown attention mode {mode!r}")
    if mask is not None:
        scores = scores.masked_fill(~mask, torch.finfo(scores.dtype).min)
    return torch.softmax(scores, dim=-1)


def pfp_attention(q, k, v, scale: float, mask: Optional[torch.Tensor] = None,
                  mode: str = MEAN_FIELD) -> GaussianTensor:
    """PFP attention over (B, H, T, D) GaussianTensors. Emits VAR."""
    q, k, v = as_gaussian(q), as_gaussian(k), as_gaussian(v)
    probs = pfp_attention_weights(q, k, scale, mask=mask, mode=mode)
    mean = torch.einsum("bhqk,bhkd->bhqd", probs, v.mean)
    var = torch.einsum("bhqk,bhkd->bhqd", torch.square(probs), v.var)
    return GaussianTensor(mean, var, VAR)
