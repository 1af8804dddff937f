"""Flash-style mean-field PFP attention on Hopper: out_mu = P.mu_v and
out_var = P^2.var_v from one online softmax.

Replaces ``repro/kernels/pfp_attention.py``: ``pfp_attention_pallas``, the
full-sequence kernel without a KV cache. The kernel is
``csrc/pfp_attention.cu``, one block per (batch x head, 64 query rows),
bound by fp32 operations; its source says how it is built. The plain
version is ``pfp_attention_ref`` (``kernels/ref.py``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import LAUNCHES, cuda_operands, stream_ptr
from repro_torch.kernels.ref import pfp_attention_ref  # noqa: F401

# The reduced test config and granite-8b; 64 (musicgen) and 256 (gemma)
# come with the paths that serve those models.
HEAD_DIMS = (16, 128)


def pfp_attention_cuda(q_mu, k_mu, v_mu, v_var, *, scale: float,
                       causal: bool = True):
    """Launch the attention kernel: q (B, H, Tq, D) x k, v (B, Hkv, Tk, D)
    CUDA tensors, H a multiple of Hkv. Returns fp32 (mean, var) of q's
    shape."""
    q_mu, k_mu, v_mu, v_var = cuda_operands(q_mu, k_mu, v_mu, v_var)
    if q_mu.dim() != 4 or k_mu.dim() != 4:
        raise ValueError(f"attention takes (B, H, T, D) tensors, got "
                         f"{tuple(q_mu.shape)} and {tuple(k_mu.shape)}")
    b, h, tq, d = q_mu.shape
    hkv, tk = k_mu.shape[1], k_mu.shape[2]
    if (k_mu.shape != (b, hkv, tk, d) or v_mu.shape != k_mu.shape
            or v_var.shape != k_mu.shape or h % hkv):
        raise ValueError(f"attention shapes q {tuple(q_mu.shape)}, k "
                         f"{tuple(k_mu.shape)}, v {tuple(v_mu.shape)}, "
                         f"v_var {tuple(v_var.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"no attention kernel for head_dim {d}; built for "
                         f"{HEAD_DIMS}")
    if b * h > 65535:
        raise ValueError(f"B * H = {b * h} is above the grid's 65535")
    out_mu = torch.empty_like(q_mu)
    out_var = torch.empty_like(q_mu)
    if q_mu.numel() == 0:
        return out_mu, out_var
    lib = _build.load()
    with torch.cuda.device(q_mu.device):
        status = lib.pfp_attention_launch(
            q_mu.data_ptr(), k_mu.data_ptr(), v_mu.data_ptr(),
            v_var.data_ptr(), out_mu.data_ptr(), out_var.data_ptr(), b, h,
            hkv, tq, tk, d, scale, int(causal), stream_ptr(q_mu.device))
    _build.check(status, "pfp_attention_launch")
    LAUNCHES["attention"] += 1
    return out_mu, out_var
