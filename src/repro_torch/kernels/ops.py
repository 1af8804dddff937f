"""The kernel wrappers: shape plumbing and device routing.

Counterpart of ``repro/kernels/ops.py``. Each wrapper flattens leading
dims to the 2-D problem its kernel takes and reshapes the result back. The
CUDA kernels mask their own ragged edges, so nothing is padded or sliced.

Routing is by the device the tensors lie on and nothing else:

  * CPU tensors run the kernel's plain version (``kernels/ref.py``);
  * CUDA tensors launch the hand-written kernel, or the launch raises.
    There is no fallback from a CUDA tensor to the plain version.

The kernels have no backward (the reference gives its Pallas kernels
none), so on either device a wrapper refuses an operand that requires a
gradient while grad mode is on, rather than return a result cut off from
autograd.

Each launcher counts its launches in ``kernels/_launch.py``'s ``LAUNCHES``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.pfp_activations import (pfp_activation_cuda,
                                                 pfp_glu_cuda)
from repro_torch.kernels.pfp_attention import (pfp_attention_cache_cuda,
                                               pfp_attention_cuda,
                                               pfp_attention_paged_cuda)
from repro_torch.kernels.pfp_dense import (MODE_FIRST_LAYER, MODE_SRM,
                                           MODE_VAR, pfp_dense_cuda)
from repro_torch.kernels.pfp_fused import (check_config, default_tile,
                                           pfp_norm_dense_act_cuda)
from repro_torch.kernels.pfp_maxpool import pfp_maxpool2d_cuda
from repro_torch.kernels.pfp_moe import pfp_dense_batched_cuda
from repro_torch.kernels.pfp_norms import pfp_norm_cuda


def _on_cuda(*operands) -> bool:
    """Whether the call launches the kernel (the first operand lies on a
    CUDA device) or runs its plain version. Raises where an operand
    needs a gradient that the kernel cannot give."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in operands):
        raise RuntimeError(
            "the kernel impl has no backward: an operand requires grad; "
            "run it under torch.no_grad() or use impl='eager'")
    return operands[0].device.type == "cuda"


def _dense(mode, x_a, x_b, w_a, w_b):
    lead, kdim, n = x_a.shape[:-1], x_a.shape[-1], w_a.shape[-1]
    x_a, x_b = x_a.reshape(-1, kdim), x_b.reshape(-1, kdim)
    if _on_cuda(x_a, x_b, w_a, w_b):
        mu, var = pfp_dense_cuda(x_a, x_b, w_a, w_b, mode=mode)
    elif mode == MODE_FIRST_LAYER:
        mu, var = ref.pfp_dense_first_layer_ref(x_a, w_a, w_b)
    elif mode == MODE_VAR:
        mu, var = ref.pfp_dense_var_ref(x_a, x_b, w_a, w_b)
    else:
        mu, var = ref.pfp_dense_ref(x_a, x_b, w_a, w_b)
    return mu.reshape(*lead, n), var.reshape(*lead, n)


def pfp_dense(mu_x, srm_x, mu_w, srm_w, *, first_layer: bool = False):
    """Joint PFP dense for (..., K) x (K, N), Eq. 12. Returns (mean, var).

    ``first_layer=True`` is Eq. 13 for deterministic inputs: the operands
    are read as (x, x, mu_w, var_w)."""
    mode = MODE_FIRST_LAYER if first_layer else MODE_SRM
    return _dense(mode, mu_x, srm_x, mu_w, srm_w)


def pfp_dense_var(mu_x, var_x, mu_w, var_w):
    """Joint PFP dense, Eq. 7, for (..., K) x (K, N). Returns (mean, var)."""
    return _dense(MODE_VAR, mu_x, var_x, mu_w, var_w)


def pfp_dense_batched(mu_x, srm_x, mu_w, srm_w, *, first_layer: bool = False,
                      rows=None):
    """Batched-expert joint PFP dense, Eq. 12, for (E, C, K) x (E, K, N):
    one independent dense per expert. Returns (mean, var), each (E, C, N).

    ``first_layer=True`` is Eq. 13: the operands are read as
    (x, x, mu_w, var_w). ``rows``: None, or int32 (E,) kept rows per
    expert (a prefix of C); the rest come out as zeros."""
    if _on_cuda(mu_x, srm_x, mu_w, srm_w):
        mode = MODE_FIRST_LAYER if first_layer else MODE_SRM
        return pfp_dense_batched_cuda(mu_x, srm_x, mu_w, srm_w, mode=mode,
                                      rows=rows)
    if first_layer:
        return ref.pfp_dense_batched_first_layer_ref(mu_x, mu_w, srm_w, rows)
    return ref.pfp_dense_batched_ref(mu_x, srm_x, mu_w, srm_w, rows)


def pfp_dense_batched_var(mu_x, var_x, mu_w, var_w, *, rows=None):
    """Batched-expert joint PFP dense, Eq. 7, for (E, C, K) x (E, K, N).
    Returns (mean, var), each (E, C, N); ``rows`` as above."""
    if _on_cuda(mu_x, var_x, mu_w, var_w):
        return pfp_dense_batched_cuda(mu_x, var_x, mu_w, var_w, mode=MODE_VAR,
                                      rows=rows)
    return ref.pfp_dense_batched_var_ref(mu_x, var_x, mu_w, var_w, rows)


def pfp_activation(mu, var, *, kind: str = "relu"):
    """Moment-matched activation, any shape. Returns (mean, srm)."""
    if _on_cuda(mu, var):
        return pfp_activation_cuda(mu, var, kind=kind)
    return ref.pfp_activation_ref(mu, var, kind)


def pfp_maxpool2d(mu, second, *, rep: str = "var"):
    """2x2/2 PFP max pool on NHWC. ``second`` is the variance, or E[x^2]
    with ``rep="srm"`` (converted as ``GaussianTensor.to_var()`` does).
    Returns (mean, var)."""
    if _on_cuda(mu, second):
        return pfp_maxpool2d_cuda(mu, second, rep=rep)
    if rep == "srm":
        second = second - torch.square(mu)
    elif rep != "var":
        raise ValueError(f"unknown rep {rep!r}")
    return ref.pfp_maxpool2d_ref(mu, second)


def pfp_rmsnorm(mu, second, gain, *, rep: str = "var", eps: float = 1e-6,
                act=None):
    """PFP RMSNorm over the last axis, any leading shape. Returns
    (mean, var), or (mean, srm) with the activation epilogue ``act``."""
    if _on_cuda(mu, second, gain):
        return pfp_norm_cuda(mu, second, gain, norm="rmsnorm", rep=rep,
                             eps=eps, act=act)
    return ref.pfp_rmsnorm_ref(mu, second, gain, rep=rep, eps=eps, act=act)


def pfp_layernorm(mu, second, gain, bias=None, *, rep: str = "var",
                  eps: float = 1e-6, act=None):
    """PFP LayerNorm over the last axis, any leading shape. Returns
    (mean, var), or (mean, srm) with the activation epilogue ``act``."""
    if _on_cuda(mu, second, gain, bias):
        return pfp_norm_cuda(mu, second, gain, bias, norm="layernorm",
                             rep=rep, eps=eps, act=act)
    return ref.pfp_layernorm_ref(mu, second, gain, bias, rep=rep, eps=eps,
                                 act=act)


def pfp_norm_dense_act(mu, second, gain, bias, mu_w, srm_w, *,
                       norm: str = "rmsnorm", rep: str = "var",
                       eps: float = 1e-6, act: str = "silu", schedule=None):
    """The fused norm -> dense -> activation unit for (..., K) x (K, N):
    the norm input's (mean, second) in ``rep``, the norm's gain and
    (LayerNorm) ``bias``, the dense weight's (mean, srm). Returns
    (mean, srm). ``schedule`` (a ``norm_dense_act`` Schedule) picks the
    kernel's tile; without one it is the tile the unfused chain's dense
    runs (``pfp_fused.default_tile``). Norm, rep, activation and tile are
    checked on either device, so the plain version takes exactly what the
    kernel takes."""
    lead, k, n = mu.shape[:-1], mu.shape[-1], mu_w.shape[-1]
    mu, second = mu.reshape(-1, k), second.reshape(-1, k)
    tile = default_tile(mu.shape[0], n, k) if schedule is None else (
        schedule.block("block_m"), schedule.block("block_n"))
    check_config(norm, rep, act, tile)
    if _on_cuda(mu, second, gain, bias, mu_w, srm_w):
        mean, srm = pfp_norm_dense_act_cuda(mu, second, gain, bias, mu_w,
                                            srm_w, norm=norm, rep=rep,
                                            eps=eps, act=act, tile=tile)
    else:
        mean, srm = ref.pfp_norm_dense_act_ref(mu, second, gain, bias, mu_w,
                                               srm_w, norm=norm, rep=rep,
                                               eps=eps, act=act)
    return mean.reshape(*lead, n), srm.reshape(*lead, n)


def pfp_glu_product(mu_a, srm_a, mu_b, srm_b):
    """Exact SRM product of independent Gaussians, any shape. Returns
    (mean, srm)."""
    if _on_cuda(mu_a, srm_a, mu_b, srm_b):
        return pfp_glu_cuda(mu_a, srm_a, mu_b, srm_b)
    return ref.pfp_glu_ref(mu_a, srm_a, mu_b, srm_b)


def pfp_attention(q_mu, k_mu, v_mu, v_var, *, scale: float,
                  causal: bool = True):
    """Mean-field PFP attention, q (B, H, Tq, D) x k, v (B, Hkv, Tk, D),
    H % Hkv == 0, right-aligned causality. Returns (mean, var)."""
    if _on_cuda(q_mu, k_mu, v_mu, v_var):
        return pfp_attention_cuda(q_mu, k_mu, v_mu, v_var, scale=scale,
                                  causal=causal)
    return ref.pfp_attention_ref(q_mu, k_mu, v_mu, v_var, scale, causal)


def pfp_attention_cache(q_mu, k_mu, v_mu, v_var, q_start, kv_len, *,
                        scale: float, causal: bool = True, window=None):
    """KV-cache PFP attention, q (B, H, Tq, D) x cache (B, Hkv, S, D);
    q_start / kv_len (B,): query row i of batch b at position
    ``q_start[b] + i``, key j real iff ``j < kv_len[b]``; optional sliding
    ``window``. Returns (mean, var)."""
    if _on_cuda(q_mu, k_mu, v_mu, v_var):
        return pfp_attention_cache_cuda(q_mu, k_mu, v_mu, v_var, q_start,
                                        kv_len, scale=scale, causal=causal,
                                        window=window)
    return ref.pfp_attention_cache_ref(q_mu, k_mu, v_mu, v_var, q_start,
                                       kv_len, scale, causal=causal,
                                       window=window)


def pfp_attention_paged(q_mu, k_pages, v_pages, vv_pages, page_table,
                        q_start, kv_len, *, scale: float, causal: bool = True,
                        window=None):
    """Paged KV-cache PFP attention: q (B, H, Tq, D) against page pools
    (NP, Hkv, page_size, D) read through ``page_table`` (B, P); masking as
    in :func:`pfp_attention_cache`. Returns (mean, var)."""
    if _on_cuda(q_mu, k_pages, v_pages, vv_pages):
        return pfp_attention_paged_cuda(q_mu, k_pages, v_pages, vv_pages,
                                        page_table, q_start, kv_len,
                                        scale=scale, causal=causal,
                                        window=window)
    return ref.pfp_attention_paged_ref(q_mu, k_pages, v_pages, vv_pages,
                                       page_table, q_start, kv_len, scale,
                                       causal=causal, window=window)
