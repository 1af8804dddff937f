"""Multi-head attention with grouped queries: the cache-free path.

Counterpart of ``repro/nn/attention.py`` without a KV cache (decode and
the paged cache come with slice 3 of ROADMAP.md).

  DETERMINISTIC : softmax attention on the weight means.
  PFP           : mean-field attention: probabilities from the score means
      (probit-corrected by the query variances under ``variance_corrected``),
      mean out = A @ mu_v, var out = A^2 @ var_v.

Grouped-query attention keeps K/V at ``num_kv_heads``; query head h reads
KV head h // group (kv-major), and K/V are never repeated on the kernel
path.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.core import dispatch, pfp_math
from repro_torch.core.device import DeviceLike
from repro_torch.core.gaussian import VAR, GaussianTensor, is_gaussian
from repro_torch.core.masking import attention_valid_mask, mask_scores
from repro_torch.core.pfp_attention import MEAN_FIELD, VARIANCE_CORRECTED
from repro_torch.nn.layers import dense_init, rope_angles, rope_apply
from repro_torch.nn.module import Context

# Query-block size of the chunked core: the (bq, Tk) score tile is its peak
# attention memory, never (Tq, Tk).
_QUERY_CHUNK = 1024


class Attention(nn.Module):
    """Projections ``wq`` (d, H*Dh), ``wk``/``wv`` (d, Hkv*Dh), ``wo``."""

    def __init__(self, d_model: int, num_heads: int, num_kv_heads: int,
                 head_dim: int, *, sigma_init: float = 1e-4,
                 generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None):
        super().__init__()
        kw = dict(sigma_init=sigma_init, generator=generator, device=device)
        self.wq = dense_init(d_model, num_heads * head_dim, **kw)
        self.wk = dense_init(d_model, num_kv_heads * head_dim, **kw)
        self.wv = dense_init(d_model, num_kv_heads * head_dim, **kw)
        self.wo = dense_init(num_heads * head_dim, d_model, **kw)


def _split_heads(x, num_heads: int, head_dim: int):
    if is_gaussian(x):
        return GaussianTensor(_split_heads(x.mean, num_heads, head_dim),
                              _split_heads(x.second, num_heads, head_dim),
                              x.rep)
    b, t, _ = x.shape
    return x.reshape(b, t, num_heads, head_dim).transpose(1, 2)


def _merge_heads(x):
    if is_gaussian(x):
        return GaussianTensor(_merge_heads(x.mean), _merge_heads(x.second),
                              x.rep)
    b, h, t, d = x.shape
    return x.transpose(1, 2).reshape(b, t, h * d)


def attention_apply(layer: Attention, x, ctx: Context, *, num_heads: int,
                    num_kv_heads: int, head_dim: int, positions,
                    causal: bool = True, window: Optional[int] = None,
                    rope_theta: Optional[float] = 1e4,
                    standard_positions: bool = False):
    """x (B, Tq, d_model), plain or Gaussian; positions (B, Tq) absolute.
    ``standard_positions``: the positions are 0..Tq-1 for every row, which
    the kernel's index-based causal mask needs."""
    if ctx.attention_mode not in (MEAN_FIELD, VARIANCE_CORRECTED):
        raise ValueError(f"unknown attention mode {ctx.attention_mode!r}")
    scale = head_dim ** -0.5
    group = num_heads // num_kv_heads

    q = _split_heads(layer.wq(x, ctx), num_heads, head_dim)
    k = _split_heads(layer.wk(x, ctx), num_kv_heads, head_dim)
    v = _split_heads(layer.wv(x, ctx), num_kv_heads, head_dim)
    if rope_theta is not None:
        cos, sin = rope_angles(positions, head_dim, rope_theta)  # (B, T, Dh/2)
        cos, sin = cos[:, None], sin[:, None]
        q = rope_apply(q, cos, sin)
        k = rope_apply(k, cos, sin)

    pfp = is_gaussian(q)
    k_mu = k.mean if pfp else k
    v_mu = v.mean if pfp else v
    v_var = v.var if pfp else None

    def _group(arr):  # (B, H, T, D) -> (B, Hkv, G, T, D)
        b, _, t, d = arr.shape
        return arr.reshape(b, num_kv_heads, group, t, d)

    q_mu = _group(q.mean if pfp else q)
    q_var = (_group(q.var)
             if pfp and ctx.attention_mode == VARIANCE_CORRECTED else None)

    # The kernel masks causally by index and knows neither windows nor
    # probit-corrected scores: everything else takes the chunked core.
    use_kernel = (pfp and dispatch.resolve_impl(ctx.impl) == "kernel"
                  and q_var is None)
    if use_kernel and window is None and (standard_positions or not causal):
        out_mu, out_var = _attention_registry(
            q_mu, k_mu, v_mu, v_var, scale=scale, causal=causal,
            impl=ctx.impl)
    else:
        out_mu, out_var = _attention_core(
            q_mu, q_var, k_mu, v_mu, v_var, q_pos=positions, k_pos=positions,
            causal=causal, window=window, scale=scale,
            chunk_size=_QUERY_CHUNK)
    b = out_mu.shape[0]
    out = out_mu.reshape(b, num_heads, -1, head_dim)
    if pfp:
        out = GaussianTensor(out, out_var.reshape(b, num_heads, -1, head_dim),
                             VAR)
    return layer.wo(_merge_heads(out), ctx)


def _attention_registry(q_mu, k_mu, v_mu, v_var, *, scale, causal, impl):
    """Grouped attention through the registry op: the queries' (Hkv, G)
    grouping collapses into kv-major heads, K/V stay at Hkv heads."""
    b, hkv, g, tq, dh = q_mu.shape
    out_mu, out_var = dispatch.pfp_attention(
        q_mu.reshape(b, hkv * g, tq, dh), k_mu, v_mu, v_var, scale=scale,
        causal=causal, impl=impl)
    return (out_mu.reshape(b, hkv, g, tq, dh),
            out_var.reshape(b, hkv, g, tq, dh))


def _attention_core(q_mu, q_var, k_mu, v_mu, v_var, *, q_pos, k_pos, causal,
                    window, scale, chunk_size):
    """Grouped masked softmax attention with joint mean / variance outputs.

    q (B, Hkv, G, Tq, D); k, v (B, Hkv, Tk, D); q_pos (B, Tq), k_pos
    (B, Tk). Queries longer than ``chunk_size`` (and a multiple of it) go
    in blocks of ``chunk_size``. Returns (out_mu, out_var or None)."""

    def block(qb_mu, qb_var, qb_pos):
        scores = torch.einsum("bhgqd,bhkd->bhgqk", qb_mu, k_mu) * scale
        if qb_var is not None:
            score_var = torch.einsum("bhgqd,bhkd->bhgqk", qb_var,
                                     torch.square(k_mu)) * (scale * scale)
            scores = pfp_math.probit_corrected_logits(scores, score_var)
        mask = attention_valid_mask(qb_pos[..., :, None], k_pos[..., None, :],
                                    causal=causal, window=window or None)
        probs = torch.softmax(mask_scores(scores, mask[:, None, None]), dim=-1)
        o_mu = torch.einsum("bhgqk,bhkd->bhgqd", probs, v_mu)
        o_var = (torch.einsum("bhgqk,bhkd->bhgqd", torch.square(probs), v_var)
                 if v_var is not None else None)
        return o_mu, o_var

    tq = q_mu.shape[3]
    if tq <= chunk_size or tq % chunk_size:
        return block(q_mu, q_var, q_pos)
    outs = [block(q_mu[:, :, :, i:i + chunk_size],
                  None if q_var is None else q_var[:, :, :, i:i + chunk_size],
                  q_pos[:, i:i + chunk_size])
            for i in range(0, tq, chunk_size)]
    o_mu = torch.cat([o[0] for o in outs], dim=3)
    o_var = None if v_var is None else torch.cat([o[1] for o in outs], dim=3)
    return o_mu, o_var
