"""GaussianTensor-level PFP layers: the port's ``eager`` impl.

Counterpart of ``repro/core/pfp_layers.py``, written from
``core/pfp_math.py`` and not from the kernels. It keeps the representation
contract: compute layers (dense / einsum / conv) consume SRM and emit VAR,
activations consume VAR and emit SRM.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import pfp_math
from repro_torch.core.gaussian import SRM, VAR, GaussianTensor, is_gaussian

# name -> fn(mean, var) -> (mean, srm)
ACTIVATION_MOMENTS = {
    "relu": pfp_math.relu_moments,
    "gelu": pfp_math.gelu_moments,
    "silu": pfp_math.silu_moments,
    "tanh": pfp_math.tanh_moments,
    "sigmoid": pfp_math.sigmoid_moments,
}

DETERMINISTIC_ACTIVATIONS = {
    "relu": torch.relu,
    "gelu": pfp_math.gelu_tanh,
    "silu": F.silu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
}


def pfp_activation(x: GaussianTensor, kind: str) -> GaussianTensor:
    """Moment-matched elementwise activation. VAR in, SRM out."""
    mean, srm = ACTIVATION_MOMENTS[kind](x.mean, x.var)
    return GaussianTensor(mean, srm, SRM)


def pfp_einsum(subscripts: str, x, w: GaussianTensor,
               formulation: str = "srm") -> GaussianTensor:
    """PFP contraction (the paper's dense layer, Eqs. 4/12/13).

    A deterministic ``x`` (a plain tensor) takes the first-layer
    simplification, Eq. 13. Emits VAR.
    """
    if not is_gaussian(x):
        mean = torch.einsum(subscripts, x, w.mean)
        var = torch.einsum(subscripts, torch.square(x), w.var)
        return GaussianTensor(mean, var, VAR)

    mean = torch.einsum(subscripts, x.mean, w.mean)
    if formulation == "srm":
        # Eq. 12: three contractions, reusing precomputed SRMs.
        var = torch.einsum(subscripts, x.srm, w.srm) - torch.einsum(
            subscripts, torch.square(x.mean), torch.square(w.mean))
    elif formulation == "var":
        # Eq. 7: four contractions (the Fig. 5 ablation).
        xv, wv = x.var, w.var
        var = (torch.einsum(subscripts, xv, torch.square(w.mean))
               + torch.einsum(subscripts, torch.square(x.mean), wv)
               + torch.einsum(subscripts, xv, wv))
    else:
        raise ValueError(f"unknown formulation: {formulation}")
    return GaussianTensor(mean, var, VAR)


def pfp_dense(x, w: GaussianTensor, b: Optional[GaussianTensor] = None,
              formulation: str = "srm") -> GaussianTensor:
    """PFP dense layer: y = x @ W (+ b), x: (..., K), W: (K, N)."""
    out = pfp_einsum("...k,kn->...n", x, w, formulation=formulation)
    if b is not None:
        out = GaussianTensor(out.mean + b.mean, out.var + b.var, VAR)
    return out


def pfp_embedding(table: GaussianTensor, ids) -> GaussianTensor:
    """Bayesian embedding lookup. Emits VAR. The rows are gathered first and
    their variance formed after: elementwise the same as converting the
    whole table, without touching the rows no token reads."""
    return GaussianTensor(table.mean[ids], table.second[ids],
                          table.rep).to_var()


def pfp_rmsnorm(x: GaussianTensor, gain, eps: float = 1e-6) -> GaussianTensor:
    """RMSNorm by the delta method: E[rms^2] = mean_j E[x_j^2] = mean(SRM)
    is taken as a deterministic per-token scalar, so the layer is affine.
    Emits VAR."""
    norm = torch.rsqrt(torch.mean(x.srm, dim=-1, keepdim=True) + eps)
    scale = norm * gain
    return GaussianTensor(x.mean * scale, x.var * torch.square(scale), VAR)


def pfp_layernorm(x: GaussianTensor, gain, bias=None,
                  eps: float = 1e-6) -> GaussianTensor:
    """LayerNorm by the delta method on the token's mean and spread, the
    spread in its centred form mean_j(var_j + (mu_j - mu_tok)^2). Emits
    VAR."""
    mu_tok = torch.mean(x.mean, dim=-1, keepdim=True)
    spread = torch.mean(x.var + torch.square(x.mean - mu_tok), dim=-1,
                        keepdim=True)
    scale = torch.rsqrt(spread + eps) * gain
    mean = (x.mean - mu_tok) * scale
    if bias is not None:
        mean = mean + bias
    return GaussianTensor(mean, x.var * torch.square(scale), VAR)


def pfp_glu_product(a: GaussianTensor, b: GaussianTensor) -> GaussianTensor:
    """Gated product a * b of independent Gaussians, exact in SRM form.
    Emits SRM."""
    mean, srm = pfp_math.product_srm(a.mean, a.srm, b.mean, b.srm)
    return GaussianTensor(mean, srm, SRM)


def pfp_residual(x: GaussianTensor, y: GaussianTensor) -> GaussianTensor:
    """Residual add of independent Gaussians: means add, variances add."""
    return GaussianTensor(x.mean + y.mean, x.var + y.var, VAR)


def pfp_maxpool2d(x: GaussianTensor, window: int = 2) -> GaussianTensor:
    """PFP 2x2/2 max pool (NHWC) as a tournament of Clark pairwise maxes:
    W pairs, then H pairs. VAR in, VAR out."""
    if window != 2:
        raise ValueError("the PFP max pool is specialised to k=2")
    m, v = x.mean, x.var

    def pair_reduce(m, v, axis):
        lo_m, hi_m = _split_pairs(m, axis)
        lo_v, hi_v = _split_pairs(v, axis)
        mean, srm = pfp_math.clark_max_moments(lo_m, lo_v, hi_m, hi_v)
        return mean, torch.clamp(srm - torch.square(mean), min=0.0)

    m, v = pair_reduce(m, v, axis=2)  # W
    m, v = pair_reduce(m, v, axis=1)  # H
    return GaussianTensor(m, v, VAR)


def _split_pairs(a: torch.Tensor, axis: int):
    n = a.shape[axis]
    if n % 2:
        raise ValueError(f"pool axis {axis} not divisible by 2: {tuple(a.shape)}")
    a = a.unflatten(axis, (n // 2, 2))
    return a.select(axis + 1, 0), a.select(axis + 1, 1)


def _same_pads(size: int, k: int, stride: int):
    """XLA's SAME padding for one spatial dim: (low, high)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _patches(arr: torch.Tensor, kh: int, kw: int, stride: int, padding: str):
    """(N, H, W, C) -> (N, Ho, Wo, C*kh*kw), features channel-major
    (c, kh, kw) as ``jax.lax.conv_general_dilated_patches`` emits them.

    Built from strided views and one copy. ``F.unfold`` is not used: on
    CUDA it launches one im2col kernel per image."""
    n, h, w, c = arr.shape
    if padding == "SAME":
        ph, pw = _same_pads(h, kh, stride), _same_pads(w, kw, stride)
        arr = F.pad(arr, (0, 0, pw[0], pw[1], ph[0], ph[1]))
    elif padding != "VALID":
        raise ValueError(f"unknown padding: {padding}")
    windows = arr.unfold(1, kh, stride).unfold(2, kw, stride)  # N,Ho,Wo,C,kh,kw
    return windows.reshape(*windows.shape[:3], c * kh * kw)


def im2col(x, w: GaussianTensor, stride: int = 1, padding: str = "VALID"):
    """Conv-as-dense plumbing shared by both impls.

    Returns ``(patches, w2)``: patches (N, Ho, Wo, cin*kh*kw), in SRM rep
    when ``x`` is Gaussian, and the HWIO weight reshaped to the matching
    (cin*kh*kw, cout) layout.
    """
    kh, kw, cin, cout = w.shape
    w2 = GaussianTensor(
        w.mean.permute(2, 0, 1, 3).reshape(cin * kh * kw, cout),
        w.second.permute(2, 0, 1, 3).reshape(cin * kh * kw, cout), w.rep)
    if not is_gaussian(x):
        return _patches(x, kh, kw, stride, padding), w2
    return GaussianTensor(_patches(x.mean, kh, kw, stride, padding),
                          _patches(x.srm, kh, kw, stride, padding), SRM), w2


def pfp_conv2d_im2col(x, w: GaussianTensor, stride: int = 1,
                      padding: str = "VALID",
                      formulation: str = "srm") -> GaussianTensor:
    """PFP conv2d (NHWC input, HWIO weight) via im2col + PFP dense."""
    xp, w2 = im2col(x, w, stride=stride, padding=padding)
    return pfp_dense(xp, w2, formulation=formulation)
