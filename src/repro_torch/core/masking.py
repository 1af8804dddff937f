"""Attention validity masking (counterpart of ``repro/core/masking.py``).

One definition of which (query, key) score positions are real, shared by
the chunked core of ``nn/attention.py`` and the plain attention versions in
``kernels/ref.py``; the CUDA kernels apply the same rule by index.
"""
from __future__ import annotations

from typing import Optional

import torch

# Large-negative score for masked positions: exp(NEG_INF - row_max)
# underflows to exactly 0 in fp32, so masked columns add exact zeros.
NEG_INF = -1e30


def attention_valid_mask(q_idx, k_idx, *, causal: bool = True,
                         window: Optional[int] = None, kv_len=None):
    """Boolean mask of valid score positions from absolute indices that
    broadcast against each other (trailing dims (Tq, Tk)). ``window``: keys
    must satisfy ``k_idx > q_idx - window``. ``kv_len``: per-row valid key
    count, broadcastable against the index grid (key j is real iff
    ``k_idx < kv_len``): the per-batch ``cache_len`` of KV-cache decode."""
    if causal:
        m = q_idx >= k_idx
    else:
        m = torch.ones(torch.broadcast_shapes(q_idx.shape, k_idx.shape),
                       dtype=torch.bool, device=q_idx.device)
    if window is not None:
        m = m & (k_idx > q_idx - window)
    if kv_len is not None:
        m = m & (k_idx < kv_len)
    return m


def mask_scores(scores, valid):
    """Masked score positions -> NEG_INF."""
    return scores.masked_fill(~valid, NEG_INF)
