"""Plain PyTorch versions of the port's hand-written kernels.

Counterpart of ``repro/kernels/ref.py``. Each function computes exactly
what one CUDA kernel computes, from ``core/pfp_math.py``, in fp32. The
kernel wrappers (``kernels/ops.py``) run these for tensors on the CPU;
``chip_smoke.py`` and the GPU tests hold each kernel against them on the
card.
"""
from __future__ import annotations

import torch

from repro_torch.core import pfp_math
from repro_torch.core.masking import attention_valid_mask, mask_scores

_F32 = torch.float32


def pfp_dense_ref(mu_x, srm_x, mu_w, srm_w):
    """Joint PFP dense, SRM formulation (Eq. 4 + Eq. 12)."""
    mu_x, srm_x, mu_w, srm_w = (a.to(_F32) for a in (mu_x, srm_x, mu_w, srm_w))
    mu = mu_x @ mu_w
    var = srm_x @ srm_w - torch.square(mu_x) @ torch.square(mu_w)
    return mu, var


def pfp_dense_first_layer_ref(x, mu_w, var_w):
    """First-layer simplification (Eq. 13): deterministic inputs."""
    x, mu_w, var_w = (a.to(_F32) for a in (x, mu_w, var_w))
    return x @ mu_w, torch.square(x) @ var_w


def pfp_dense_var_ref(mu_x, var_x, mu_w, var_w):
    """Joint PFP dense, Eq. 7 formulation: four contractions."""
    mx, vx, mw, vw = (a.to(_F32) for a in (mu_x, var_x, mu_w, var_w))
    mu = mx @ mw
    var = vx @ torch.square(mw) + torch.square(mx) @ vw + vx @ vw
    return mu, var


# The batched-expert dense: the same formulas with a leading expert axis,
# (E,C,K) x (E,K,N) -> (E,C,N), one independent product per expert. ``@``
# batches over that axis (the reference vmaps its 2-D versions). ``rows``
# (None, or E kept-row counts) zeroes each expert's rows from its count on,
# as the kernel writes them.
def _zero_rows(out, rows):
    if rows is None:
        return out
    c = out[0].shape[1]
    keep = (torch.arange(c, device=out[0].device)[None, :, None]
            < rows.to(out[0].device)[:, None, None])
    return tuple(torch.where(keep, o, 0.0) for o in out)


def pfp_dense_batched_ref(mu_x, srm_x, mu_w, srm_w, rows=None):
    return _zero_rows(pfp_dense_ref(mu_x, srm_x, mu_w, srm_w), rows)


def pfp_dense_batched_first_layer_ref(x, mu_w, var_w, rows=None):
    return _zero_rows(pfp_dense_first_layer_ref(x, mu_w, var_w), rows)


def pfp_dense_batched_var_ref(mu_x, var_x, mu_w, var_w, rows=None):
    return _zero_rows(pfp_dense_var_ref(mu_x, var_x, mu_w, var_w), rows)


ACTIVATION_REFS = {
    "relu": pfp_math.relu_moments,
    "gelu": pfp_math.gelu_moments,
    "silu": pfp_math.silu_moments,
    "tanh": pfp_math.tanh_moments,
    "sigmoid": pfp_math.sigmoid_moments,
}


def pfp_activation_ref(mu, var, kind: str = "relu"):
    """Moment-matched activation: (mean, var) in, (mean, srm) out."""
    return ACTIVATION_REFS[kind](mu.to(_F32), var.to(_F32))


def pfp_relu_ref(mu, var):
    """Moment-matched ReLU, Eq. 8/9, the kind the paper's models run."""
    return pfp_activation_ref(mu, var, "relu")


def pfp_maxpool2d_ref(mu, var):
    """2x2/stride-2 PFP max pool on NHWC via Clark tournament (VAR->VAR)."""
    mu, var = mu.to(_F32), var.to(_F32)
    m_w, s_w = pfp_math.clark_max_moments(mu[:, :, 0::2], var[:, :, 0::2],
                                          mu[:, :, 1::2], var[:, :, 1::2])
    v_w = torch.clamp(s_w - torch.square(m_w), min=0.0)
    m, s = pfp_math.clark_max_moments(m_w[:, 0::2], v_w[:, 0::2],
                                      m_w[:, 1::2], v_w[:, 1::2])
    return m, torch.clamp(s - torch.square(m), min=0.0)


def _var_srm(mu, second, rep):
    if rep == "var":
        return second, second + torch.square(mu)
    if rep == "srm":
        return second - torch.square(mu), second
    raise ValueError(f"unknown rep {rep!r}")


def _epilogue(mean, var, act):
    """The optional activation after a norm: VAR -> SRM."""
    if act is None:
        return mean, var
    return pfp_activation_ref(mean, var, act)


def pfp_rmsnorm_ref(mu, second, gain, *, rep: str = "var", eps: float = 1e-6,
                    act=None):
    """Delta-method RMSNorm over the last axis: (mean, var) out, or
    (mean, srm) after the activation ``act``."""
    mu, second = mu.to(_F32), second.to(_F32)
    var, srm = _var_srm(mu, second, rep)
    norm = torch.rsqrt(torch.mean(srm, dim=-1, keepdim=True) + eps)
    scale = norm * gain.to(_F32)
    return _epilogue(mu * scale, var * torch.square(scale), act)


def pfp_layernorm_ref(mu, second, gain, bias=None, *, rep: str = "var",
                      eps: float = 1e-6, act=None):
    """Delta-method LayerNorm over the last axis, the token spread in its
    centred form: (mean, var) out, or (mean, srm) after ``act``."""
    mu, second = mu.to(_F32), second.to(_F32)
    var, _ = _var_srm(mu, second, rep)
    mu_tok = torch.mean(mu, dim=-1, keepdim=True)
    spread = torch.mean(var + torch.square(mu - mu_tok), dim=-1, keepdim=True)
    scale = torch.rsqrt(spread + eps) * gain.to(_F32)
    mean = (mu - mu_tok) * scale
    if bias is not None:
        mean = mean + bias.to(_F32)
    return _epilogue(mean, var * torch.square(scale), act)


def pfp_norm_dense_act_ref(mu, second, gain, bias, mu_w, srm_w, *,
                           norm: str = "rmsnorm", rep: str = "var",
                           eps: float = 1e-6, act: str = "silu"):
    """The fused unit as the unfused chain computes it: the norm (VAR out),
    ``GaussianTensor.to_srm``'s ``second + square(mean)``, the Eq. 12 dense
    and the activation, in that order. (mean, srm) out."""
    if norm == "rmsnorm":
        h_mu, h_var = pfp_rmsnorm_ref(mu, second, gain, rep=rep, eps=eps)
    elif norm == "layernorm":
        h_mu, h_var = pfp_layernorm_ref(mu, second, gain, bias, rep=rep,
                                        eps=eps)
    else:
        raise ValueError(f"unknown norm {norm!r}")
    y_mu, y_var = pfp_dense_ref(h_mu, h_var + torch.square(h_mu), mu_w, srm_w)
    return pfp_activation_ref(y_mu, y_var, act)


def pfp_glu_ref(mu_a, srm_a, mu_b, srm_b):
    """Exact SRM product of independent Gaussians: (mean, srm) out."""
    return pfp_math.product_srm(mu_a.to(_F32), srm_a.to(_F32),
                                mu_b.to(_F32), srm_b.to(_F32))


def pfp_attention_ref(q_mu, k_mu, v_mu, v_var, scale: float,
                      causal: bool = True):
    """Mean-field PFP attention, q (B, H, Tq, D) x kv (B, Hkv, Tk, D).

    Query head h reads KV head h // (H / Hkv) (kv-major grouping). Causality
    is right-aligned: query row i sits at position i + Tk - Tq. A query row
    with no valid key comes out 0, as in the flash kernel (its normaliser
    is 0 and is clamped), not as a uniform average."""
    group = q_mu.shape[1] // k_mu.shape[1]
    k_mu, v_mu, v_var = (a.to(_F32).repeat_interleave(group, dim=1)
                         for a in (k_mu, v_mu, v_var))
    s = torch.einsum("bhqd,bhkd->bhqk", q_mu.to(_F32), k_mu) * scale
    tq, tk = s.shape[-2], s.shape[-1]
    q_idx = torch.arange(tq, device=s.device)[:, None] + (tk - tq)
    valid = attention_valid_mask(q_idx, torch.arange(tk, device=s.device),
                                 causal=causal)
    p = torch.softmax(mask_scores(s, valid), dim=-1) * valid
    out_mu = torch.einsum("bhqk,bhkd->bhqd", p, v_mu)
    out_var = torch.einsum("bhqk,bhkd->bhqd", torch.square(p), v_var)
    return out_mu, out_var


def pfp_attention_cache_ref(q_mu, k_mu, v_mu, v_var, q_start, kv_len,
                            scale: float, causal: bool = True, window=None):
    """KV-cache PFP attention, q (B, H, Tq, D) x cache (B, Hkv, S, D).

    Query row i of batch b sits at absolute position ``q_start[b] + i``;
    key j is real iff ``j < kv_len[b]`` (and, with ``window``, iff
    ``j > position - window``). Query head h reads KV head h // (H / Hkv)
    in groups, without repeating K/V. A query row with no valid key (a slot
    with ``kv_len`` 0) comes out 0, as in the kernel, not as a uniform
    average."""
    b, h, tq, d = q_mu.shape
    hkv, tk = k_mu.shape[1], k_mu.shape[2]
    q = q_mu.to(_F32).reshape(b, hkv, h // hkv, tq, d)
    s = torch.einsum("bhgqd,bhkd->bhgqk", q, k_mu.to(_F32)) * scale
    q_idx = (q_start.to(s.device).long()[:, None]
             + torch.arange(tq, device=s.device))                  # (B, Tq)
    valid = attention_valid_mask(
        q_idx[:, :, None], torch.arange(tk, device=s.device)[None, None, :],
        causal=causal, window=window,
        kv_len=kv_len.to(s.device).long()[:, None, None])[:, None, None]
    p = torch.softmax(mask_scores(s, valid), dim=-1) * valid
    out_mu = torch.einsum("bhgqk,bhkd->bhgqd", p, v_mu.to(_F32))
    out_var = torch.einsum("bhgqk,bhkd->bhgqd", torch.square(p),
                           v_var.to(_F32))
    return out_mu.reshape(b, h, tq, d), out_var.reshape(b, h, tq, d)


def gather_kv_pages(pages, page_table):
    """(NP, Hkv, ps, D) x (B, P) -> contiguous (B, Hkv, P * ps, D)."""
    b, p = page_table.shape
    _, hkv, ps, d = pages.shape
    flat = pages[page_table.reshape(-1).long()]           # (B * P, Hkv, ps, D)
    return flat.reshape(b, p, hkv, ps, d).transpose(1, 2).reshape(
        b, hkv, p * ps, d)


def pfp_attention_paged_ref(q_mu, k_pages, v_pages, vv_pages, page_table,
                            q_start, kv_len, scale: float, causal: bool = True,
                            window=None):
    """Paged KV-cache PFP attention: q (B, H, Tq, D) against a pool of
    pages (NP, Hkv, page_size, D), logical page j of batch b at pool row
    ``page_table[b, j]``. The pages are gathered into a contiguous cache
    and attended as by :func:`pfp_attention_cache_ref`; padded table slots
    (trash page 0) lie at or past ``kv_len`` and are masked."""
    k, vm, vv = (gather_kv_pages(a, page_table)
                 for a in (k_pages, v_pages, vv_pages))
    return pfp_attention_cache_ref(q_mu, k, vm, vv, q_start, kv_len, scale,
                                   causal=causal, window=window)
