"""Variational Gaussian machinery: KL terms, ELBO, KL annealing (paper §4).

Counterpart of ``repro/bayes/variational.py``. The variational posterior
is a mean-field Gaussian per weight, q(w) = N(mu, exp(rho)^2); the prior
is p(w) = N(0, prior_sigma^2).

KL(q || p) per weight (closed form):
    log(prior_sigma) - rho + (exp(2 rho) + mu^2) / (2 prior_sigma^2) - 1/2

The training loss is the negative dynamically-annealed ELBO (paper Eq. 10):
    L(e) = NLL + A(e) * KL,  A(e) = alpha_max * min(1, e / anneal_epochs)
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from repro_torch.core import mesh_route
from repro_torch.nn.module import BayesParam


def gaussian_kl(mu, rho, prior_sigma: float = 1.0):
    """KL(N(mu, exp(rho)^2) || N(0, prior_sigma^2)), summed over elements."""
    var = torch.exp(2.0 * rho)
    return torch.sum(math.log(prior_sigma) - rho
                     + (var + torch.square(mu)) / (2.0 * prior_sigma ** 2)
                     - 0.5)


def total_kl(model: nn.Module, prior_sigma: float = 1.0):
    """Sum of Gaussian KLs over every variational leaf (those with ``rho``)
    of ``model``."""
    kls = [gaussian_kl(m.mu, m.rho, prior_sigma) for m in model.modules()
           if isinstance(m, BayesParam) and "rho" in m.keys()]
    return torch.sum(torch.stack(kls)) if kls else torch.zeros(())


@dataclasses.dataclass(frozen=True)
class KLSchedule:
    """Linear KL annealing (paper Eq. 10): A(e) ramps 0 -> alpha_max."""

    alpha_max: float = 0.25
    anneal_steps: int = 1000

    def __call__(self, step: int) -> float:
        frac = min(max(step / max(self.anneal_steps, 1), 0.0), 1.0)
        return self.alpha_max * frac


def elbo_loss(logits, labels, model: nn.Module, *, kl_scale, num_data: int,
              prior_sigma: float = 1.0, aux_loss=0.0):
    """Negative annealed ELBO for classification / next-token prediction.

    logits: (..., K) sampled logits (SVI mode, one MC sample per step).
    labels: (...) int class / token ids. The KL term is scaled by
    1/num_data so it is comparable to the per-example NLL (the standard
    minibatch ELBO). Returns (loss, {'nll', 'kl'})."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.mean(torch.gather(logp, -1, labels[..., None].long()))
    kl = total_kl(model, prior_sigma) / num_data
    # On a mesh: a mean's and a sum's partials add once reduced.
    nll, kl = mesh_route.whole(nll), mesh_route.whole(kl)
    return nll + kl_scale * kl + aux_loss, {"nll": nll, "kl": kl}
