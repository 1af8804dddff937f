"""Multi-head attention with grouped queries, with and without a KV cache.

Counterpart of ``repro/nn/attention.py`` (self-attention; cross-attention
comes with the VLM slice).

  DETERMINISTIC : softmax attention on the weight means.
  PFP           : mean-field attention: probabilities from the score means
      (probit-corrected by the query variances under ``variance_corrected``),
      mean out = A @ mu_v, var out = A^2 @ var_v. The KV cache keeps
      (mu_k, mu_v, var_v), so the values' uncertainty survives across
      decode steps.

Two KV-cache layouts share one decode math:

  KVCache      per-sequence buffers (B, Hkv, S, Dh);
  PagedKVCache a pool of fixed-size pages (NP, Hkv, page_size, Dh) shared
               by all sequences; a per-batch ``page_table`` (B, P) maps
               logical page j of batch b to a pool row. Page 0 is the trash
               page.

Grouped-query attention keeps K/V at ``num_kv_heads``; query head h reads
KV head h // group (kv-major), and K/V are never repeated on the kernel
paths. Cache updates are out of place, as in the reference: an attention
call returns a new cache and leaves the one it was given as it was.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from repro_torch.core import dispatch, pfp_math
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.core.gaussian import VAR, GaussianTensor, is_gaussian
from repro_torch.core.masking import attention_valid_mask, mask_scores
from repro_torch.core.pfp_attention import MEAN_FIELD, VARIANCE_CORRECTED
from repro_torch.kernels.ref import gather_kv_pages
from repro_torch.nn.layers import dense_init, rope_angles, rope_apply
from repro_torch.nn.module import Context

# Query-block size of the chunked core: the (bq, Tk) score tile is its peak
# attention memory, never (Tq, Tk).
_QUERY_CHUNK = 1024


class KVCache(NamedTuple):
    k_mu: torch.Tensor   # (B, Hkv, S, Dh)
    v_mu: torch.Tensor   # (B, Hkv, S, Dh)
    v_var: torch.Tensor  # (B, Hkv, S, Dh); zeros outside PFP mode


class PagedKVCache(NamedTuple):
    """Pools of pages shared by all sequences, (NP, Hkv, page_size, Dh)
    each; which pages belong to which sequence lives in the ``page_table``
    of the decode inputs. Page 0 is the trash page: inserts at positions
    >= ``cache_len`` (a prefill window's right padding, a parked slot) or
    below ``write_start`` go there, so they never touch a live sequence's
    pages."""
    k_mu: torch.Tensor
    v_mu: torch.Tensor
    v_var: torch.Tensor


def init_kv_cache(batch: int, num_kv_heads: int, max_len: int, head_dim: int,
                  dtype=torch.float32, device: DeviceLike = None) -> KVCache:
    shape = (batch, num_kv_heads, max_len, head_dim)
    device = resolve_device(device)
    return KVCache(*(torch.zeros(shape, dtype=dtype, device=device)
                     for _ in range(3)))


def init_paged_kv_cache(num_pages: int, num_kv_heads: int, page_size: int,
                        head_dim: int, dtype=torch.float32,
                        device: DeviceLike = None) -> PagedKVCache:
    """Zeroed page pools. ``num_pages`` includes the trash page 0."""
    shape = (num_pages, num_kv_heads, page_size, head_dim)
    device = resolve_device(device)
    return PagedKVCache(*(torch.zeros(shape, dtype=dtype, device=device)
                          for _ in range(3)))


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


def _insert_rows(buf, new, positions):
    """Contiguous cache insert at each row's own offset ``positions[:, 0]``
    (slots sit at independent positions), clamped so the rows fit, as
    ``dynamic_update_slice`` clamps in the reference. Out of place."""
    b, hkv, tq, d = new.shape
    start = positions[:, 0].clamp(0, buf.shape[2] - tq)
    idx = start[:, None] + torch.arange(tq, device=buf.device)   # (B, Tq)
    return buf.scatter(2, idx[:, None, :, None].expand(b, hkv, tq, d),
                       new.to(buf.dtype))


def _insert_pages(buf, new, dest_page, dest_row):
    """Paged cache insert: new (B, Hkv, Tq, Dh) rows to
    ``buf[dest_page, :, dest_row]`` ((B, Tq) indices each). Out of place."""
    out = buf.clone()
    out[dest_page, :, dest_row] = new.to(buf.dtype).transpose(1, 2)
    return out


def attention_apply(layer: Attention, x, ctx: Context, *, num_heads: int,
                    num_kv_heads: int, head_dim: int, positions,
                    causal: bool = True, window: Optional[int] = None,
                    rope_theta: Optional[float] = 1e4, cache=None,
                    cache_len=None, page_table=None, write_start=None,
                    standard_positions: bool = False):
    """x (B, Tq, d_model), plain or Gaussian; positions (B, Tq) absolute.

    ``cache``: a :class:`KVCache` or :class:`PagedKVCache` to append the
    new K/V rows to at ``positions``; ``cache_len`` (B,): valid entries
    including this call's (for a contiguous cache it defaults to
    ``positions[:, -1] + 1``); ``page_table`` (B, P) and ``write_start``
    (B,): a paged cache's indirection and the first position each row may
    write. ``standard_positions``: the positions are 0..Tq-1 for every row,
    which the cache-free kernel's index-based causal mask needs.

    Returns ``(output, new_cache or None)``."""
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
    v_var = v.var if pfp else torch.zeros_like(v_mu)

    new_cache = None
    paged = isinstance(cache, PagedKVCache)
    kv_len = k_valid = None
    k_pos = positions
    if paged:
        if page_table is None or cache_len is None:
            raise ValueError("PagedKVCache needs page_table and cache_len")
        ps = cache.k_mu.shape[2]
        kv_len = cache_len
        # Each new row goes to page_table[b, pos // ps], row pos % ps. Rows
        # at positions >= cache_len (a prefill window's right padding, a
        # parked slot) and below write_start (a re-fed window over pages
        # shared copy-on-write) go to the trash page 0 instead, so one
        # lockstep pass over the shared pool never writes another
        # sequence's pages.
        writable = positions < cache_len[:, None]
        if write_start is not None:
            writable = writable & (positions >= write_start[:, None])
        logical = (positions // ps).clamp(0, page_table.shape[1] - 1)
        dest_page = torch.where(
            writable, torch.gather(page_table.long(), 1, logical), 0)
        dest_row = positions % ps
        cache = PagedKVCache(*(_insert_pages(buf, new, dest_page, dest_row)
                               for buf, new in zip(cache, (k_mu, v_mu,
                                                           v_var))))
        new_cache = cache
    elif cache is not None:
        cache = KVCache(*(_insert_rows(buf, new, positions)
                          for buf, new in zip(cache, (k_mu, v_mu, v_var))))
        new_cache = cache
        k_mu, v_mu, v_var = cache
        s = k_mu.shape[2]
        kv_len = cache_len if cache_len is not None else positions[:, -1] + 1
        k_pos = torch.arange(s, device=k_mu.device).expand(positions.shape[0],
                                                           s)
        k_valid = k_pos < kv_len[:, None]

    def _group(arr):  # (B, H, T, D) -> (B, Hkv, G, T, D)
        b, _, t, d = arr.shape
        return arr.reshape(b, num_kv_heads, group, t, d)

    q_mu = _group(q.mean if pfp else q)
    q_var = (_group(q.var)
             if pfp and ctx.attention_mode == VARIANCE_CORRECTED else None)

    # Registry paths for mean-field PFP attention under the kernel impl:
    #   * the cache paths always qualify: per-row query starts, valid
    #     lengths and windows are native to the cache kernels, and the
    #     insert contract makes positions contiguous from each row's start;
    #   * without a cache the kernel masks causally by index and knows
    #     neither windows nor remapped positions, which stay on the
    #     chunked core, as probit-corrected scores do everywhere.
    use_kernel = (pfp and dispatch.resolve_impl(ctx.impl) == "kernel"
                  and q_var is None)
    if use_kernel and cache is not None:
        q_start = positions[:, 0]
        if paged:
            out_mu, out_var = _attention_paged_registry(
                q_mu, cache, page_table, q_start, kv_len, scale=scale,
                causal=causal, window=window, impl=ctx.impl)
        else:
            out_mu, out_var = _attention_cache_registry(
                q_mu, k_mu, v_mu, v_var, q_start, kv_len, scale=scale,
                causal=causal, window=window, impl=ctx.impl)
    elif (use_kernel and cache is None and window is None
          and (standard_positions or not causal)):
        out_mu, out_var = _attention_registry(
            q_mu, k_mu, v_mu, v_var, scale=scale, causal=causal,
            impl=ctx.impl)
    else:
        if paged:
            # Gather the pages into the contiguous layout, then the same
            # chunked core as the contiguous cache.
            k_mu, v_mu, v_var = (gather_kv_pages(a, page_table)
                                 for a in cache)
            s = k_mu.shape[2]
            k_pos = torch.arange(s, device=k_mu.device).expand(
                positions.shape[0], s)
            k_valid = k_pos < kv_len[:, None]
        out_mu, out_var = _attention_core(
            q_mu, q_var, k_mu, v_mu, v_var if pfp else None, q_pos=positions,
            k_pos=k_pos, k_valid=k_valid, causal=causal, window=window,
            scale=scale, chunk_size=_QUERY_CHUNK)
    b = out_mu.shape[0]
    out = out_mu.reshape(b, num_heads, -1, head_dim)
    if pfp:
        out = GaussianTensor(out, out_var.reshape(b, num_heads, -1, head_dim),
                             VAR)
    return layer.wo(_merge_heads(out), ctx), new_cache


def _attention_registry(q_mu, k_mu, v_mu, v_var, *, scale, causal, impl):
    """Grouped attention through the registry op: the queries' (Hkv, G)
    grouping collapses into kv-major heads, K/V stay at Hkv heads."""
    b, hkv, g, tq, dh = q_mu.shape
    out_mu, out_var = dispatch.pfp_attention(
        q_mu.reshape(b, hkv * g, tq, dh), k_mu, v_mu, v_var, scale=scale,
        causal=causal, impl=impl)
    return (out_mu.reshape(b, hkv, g, tq, dh),
            out_var.reshape(b, hkv, g, tq, dh))


def _attention_cache_registry(q_mu, k_mu, v_mu, v_var, q_start, kv_len, *,
                              scale, causal, window, impl):
    """Contiguous KV-cache attention through the registry op
    ``attention_cache``: per-row query starts and valid lengths."""
    b, hkv, g, tq, dh = q_mu.shape
    out_mu, out_var = dispatch.pfp_attention_cache(
        q_mu.reshape(b, hkv * g, tq, dh), k_mu, v_mu, v_var, q_start, kv_len,
        scale=scale, causal=causal, window=window, impl=impl)
    return (out_mu.reshape(b, hkv, g, tq, dh),
            out_var.reshape(b, hkv, g, tq, dh))


def _attention_paged_registry(q_mu, cache, page_table, q_start, kv_len, *,
                              scale, causal, window, impl):
    """Paged KV-cache attention through the registry op
    ``attention_paged``: the kernel reads the pages through the table, no
    contiguous gather."""
    b, hkv, g, tq, dh = q_mu.shape
    out_mu, out_var = dispatch.pfp_attention_paged(
        q_mu.reshape(b, hkv * g, tq, dh), cache.k_mu, cache.v_mu, cache.v_var,
        page_table, q_start, kv_len, scale=scale, causal=causal,
        window=window, impl=impl)
    return (out_mu.reshape(b, hkv, g, tq, dh),
            out_var.reshape(b, hkv, g, tq, dh))


def _attention_core(q_mu, q_var, k_mu, v_mu, v_var, *, q_pos, k_pos, causal,
                    window, scale, chunk_size, k_valid=None):
    """Grouped masked softmax attention with joint mean / variance outputs.

    q (B, Hkv, G, Tq, D); k, v (B, Hkv, Tk, D); q_pos (B, Tq), k_pos
    (B, Tk); k_valid (B, Tk) bool or None. Queries longer than
    ``chunk_size`` (and a multiple of it) go in blocks of ``chunk_size``.
    Returns (out_mu, out_var or None)."""

    def block(qb_mu, qb_var, qb_pos):
        scores = torch.einsum("bhgqd,bhkd->bhgqk", qb_mu, k_mu) * scale
        if qb_var is not None:
            score_var = torch.einsum("bhgqd,bhkd->bhgqk", qb_var,
                                     torch.square(k_mu)) * (scale * scale)
            scores = pfp_math.probit_corrected_logits(scores, score_var)
        mask = attention_valid_mask(qb_pos[..., :, None], k_pos[..., None, :],
                                    causal=causal, window=window or None)
        if k_valid is not None:
            mask = mask & k_valid[..., None, :]
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
