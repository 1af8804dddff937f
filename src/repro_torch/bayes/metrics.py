"""Uncertainty metrics (paper §2.2, Eqs. 1-3) and AUROC.

Counterpart of ``repro/bayes/metrics.py``. From logit samples (SVI, or PFP
with logit sampling, paper Eq. 11):

    total     = entropy of the mean predictive   H[E_n p_n]   (Eq. 1)
    aleatoric = mean softmax entropy             E_n H[p_n]   (Eq. 2)
    epistemic = mutual information               Eq.1 - Eq.2  (Eq. 3)
"""
from __future__ import annotations

import numpy as np
import torch

_EPS = 1e-12


def _entropy(p, dim=-1):
    return -torch.sum(p * torch.log(p + _EPS), dim=dim)


def predictive_metrics_from_samples(logits_samples: torch.Tensor) -> dict:
    """logits_samples: (N, B, K) -> dict of (B,) metric tensors."""
    probs = torch.softmax(logits_samples, dim=-1)            # (N, B, K)
    mean_probs = torch.mean(probs, dim=0)                    # (B, K)
    total = _entropy(mean_probs)                             # Eq. 1
    aleatoric = torch.mean(_entropy(probs), dim=0)           # Eq. 2
    mi = total - aleatoric                                   # Eq. 3
    pred = torch.argmax(mean_probs, dim=-1)
    return {"total": total, "aleatoric": aleatoric, "mi": mi, "pred": pred,
            "mean_probs": mean_probs}


def predictive_metrics_from_sample_rows(logits_samples: torch.Tensor) -> dict:
    """Row-batched Eq. 1-3 reduction: (B, N, K) -> dict of (B,) tensors.

    Row ``b`` is bit for bit
    ``predictive_metrics_from_samples(logits_samples[b, :, None])[...][0]``:
    the per-row reduction applied to each row, not a re-derivation, so a
    caller that batches N-sample SVI passes over slots gets the sequential
    path's exact numbers."""
    rows = [predictive_metrics_from_samples(s[:, None]) for s in
            logits_samples]
    return {k: torch.stack([r[k][0] for r in rows]) for k in rows[0]}


def sample_pfp_logits(generator: torch.Generator, mean, var,
                      num_samples: int):
    """Paper Eq. 11: l ~ N(mu_PFP, sigma^2_PFP) as a post-processing step.
    ``generator`` lives on the logits' device."""
    std = torch.sqrt(torch.clamp(var, min=0.0))
    eps = torch.randn((num_samples,) + tuple(mean.shape), generator=generator,
                      dtype=mean.dtype, device=mean.device)
    return mean + eps * std


def pfp_predictive_metrics(generator: torch.Generator, logit_mean, logit_var,
                           num_samples: int = 100) -> dict:
    samples = sample_pfp_logits(generator, logit_mean, logit_var, num_samples)
    return predictive_metrics_from_samples(samples)


def auroc(scores_pos, scores_neg) -> float:
    """AUROC via the Mann-Whitney U statistic (ties get half credit).

    scores_pos: uncertainty scores for OOD (positive class), scores_neg:
    for in-domain. Tensors or arrays; returns a Python float in [0, 1].
    """
    pos = _numpy(scores_pos)
    neg = _numpy(scores_neg)
    order = np.concatenate([pos, neg])
    n_pos, n_neg = len(pos), len(neg)
    ranks = np.empty(len(order))
    ranks[np.argsort(order, kind="mergesort")] = np.arange(1, len(order) + 1)
    # tie correction: average ranks per unique value
    uniq, inv = np.unique(order, return_inverse=True)
    rank_sum = np.zeros(len(uniq))
    rank_cnt = np.zeros(len(uniq))
    np.add.at(rank_sum, inv, ranks)
    np.add.at(rank_cnt, inv, 1)
    ranks = (rank_sum / rank_cnt)[inv]
    u = ranks[:n_pos].sum() - n_pos * (n_pos + 1) / 2
    return float(u / (n_pos * n_neg))


def accuracy(pred, labels) -> float:
    return float(np.mean(_numpy(pred) == _numpy(labels)))


def _numpy(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)
