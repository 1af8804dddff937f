"""Mode-polymorphic layers: dense, embedding, norms, activations, the GLU
gate, rotary and sinusoidal positions, residual adds.

Counterpart of ``repro/nn/layers.py``. DETERMINISTIC and SVI run plain
torch ops on the weight means or samples (autograd carries SVI training
through them); PFP routes every moment-propagating op through the
registry (``core/dispatch.py``), so ``ctx.impl`` selects the eager ops or
the kernels per forward.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from repro_torch.core import dispatch
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.core.gaussian import VAR, GaussianTensor, is_gaussian
from repro_torch.core.pfp_layers import DETERMINISTIC_ACTIVATIONS
from repro_torch.nn.module import (BayesParam, Context, frozen, init_bayes,
                                   resolve_weight)


class Dense(nn.Module):
    """A Bayesian dense layer: weight ``w`` (K, N), optional bias ``b``."""

    def __init__(self, w: BayesParam, b: Optional[BayesParam] = None):
        super().__init__()
        self.w = w
        self.b = b

    def forward(self, x, ctx: Context):
        return dense_apply(self, x, ctx)


def bias_init(d: int, *, sigma_init: float, dtype=torch.float32,
              device: DeviceLike = None) -> BayesParam:
    """Bias leaf: mu = 0, rho = log(sigma_init)."""
    device = resolve_device(device)
    return BayesParam(
        mu=torch.zeros((d,), dtype=dtype, device=device),
        rho=torch.full((d,), math.log(sigma_init), dtype=dtype, device=device))


def dense_init(d_in: int, d_out: int, *, sigma_init: float = 1e-4,
               bias: bool = False,
               generator: Optional[torch.Generator] = None,
               dtype=torch.float32, device: DeviceLike = None) -> Dense:
    w = init_bayes((d_in, d_out), generator=generator, fan_in=d_in,
                   sigma_init=sigma_init, dtype=dtype, device=device)
    b = (bias_init(d_out, sigma_init=sigma_init, dtype=dtype, device=device)
         if bias else None)
    return Dense(w, b)


def dense_apply(layer: Dense, x, ctx: Context):
    w = resolve_weight(layer.w, ctx)
    b = resolve_weight(layer.b, ctx) if layer.b is not None else None
    if isinstance(w, GaussianTensor):  # PFP path
        return dispatch.pfp_dense(x, w, b, formulation=ctx.formulation,
                                  impl=ctx.impl)
    y = (x.mean if is_gaussian(x) else x) @ w
    if b is not None:
        y = y + b
    return y


def activation_apply(x, kind: str, ctx: Context):
    if is_gaussian(x):
        return dispatch.pfp_activation(x, kind, impl=ctx.impl)
    return DETERMINISTIC_ACTIVATIONS[kind](x)


def glu_apply(gate, up, act_kind: str, ctx: Context):
    """Gated linear unit act(gate) * up (SwiGLU / GeGLU)."""
    if is_gaussian(gate):
        g = dispatch.pfp_activation(gate, act_kind, impl=ctx.impl)  # VAR->SRM
        return dispatch.pfp_glu_product(g, up, impl=ctx.impl)       # exact
    return DETERMINISTIC_ACTIVATIONS[act_kind](gate) * up


# -- embedding -----------------------------------------------------------------
class Embedding(nn.Module):
    """A Bayesian embedding table ``table`` (vocab, d_model)."""

    def __init__(self, table: BayesParam):
        super().__init__()
        self.table = table

    def forward(self, ids, ctx: Context):
        return embedding_apply(self, ids, ctx)


def embedding_init(vocab: int, d_model: int, *, sigma_init: float = 1e-4,
                   generator: Optional[torch.Generator] = None,
                   dtype=torch.float32, device: DeviceLike = None) -> Embedding:
    return Embedding(init_bayes((vocab, d_model), generator=generator,
                                scale=1.0, sigma_init=sigma_init, dtype=dtype,
                                device=device))


def embedding_apply(layer: Embedding, ids, ctx: Context):
    t = resolve_weight(layer.table, ctx)
    if isinstance(t, GaussianTensor):
        return dispatch.pfp_embedding(t, ids, impl=ctx.impl)
    return t[ids]


# -- norms ---------------------------------------------------------------------
class RMSNorm(nn.Module):
    """Deterministic gain ``g`` (d,)."""

    def __init__(self, d: int, *, dtype=torch.float32,
                 device: DeviceLike = None):
        super().__init__()
        self.g = frozen(torch.ones((d,), dtype=dtype,
                                   device=resolve_device(device)))

    def forward(self, x, ctx: Context, eps: float = 1e-6):
        return rmsnorm_apply(self, x, ctx, eps)


class LayerNorm(nn.Module):
    """Deterministic gain ``g`` and bias ``b`` (d,)."""

    def __init__(self, d: int, *, dtype=torch.float32,
                 device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.g = frozen(torch.ones((d,), dtype=dtype, device=device))
        self.b = frozen(torch.zeros((d,), dtype=dtype, device=device))

    def forward(self, x, ctx: Context, eps: float = 1e-6):
        return layernorm_apply(self, x, ctx, eps)


def rmsnorm_apply(layer: RMSNorm, x, ctx: Context, eps: float = 1e-6):
    g = layer.g.to(x.dtype)
    if is_gaussian(x):
        return dispatch.pfp_rmsnorm(x, g, eps=eps, impl=ctx.impl)
    norm = torch.rsqrt(torch.mean(torch.square(x), dim=-1, keepdim=True) + eps)
    return x * norm * g


def layernorm_apply(layer: LayerNorm, x, ctx: Context, eps: float = 1e-6):
    g, b = layer.g.to(x.dtype), layer.b.to(x.dtype)
    if is_gaussian(x):
        return dispatch.pfp_layernorm(x, g, b, eps=eps, impl=ctx.impl)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
    return (x - mu) * torch.rsqrt(var + eps) * g + b


NORMS = {"rmsnorm": RMSNorm, "layernorm": LayerNorm}


# -- rotary and sinusoidal positions --------------------------------------------
def rope_angles(positions, head_dim: int, theta: float = 1e4):
    """positions (..., T) integers -> cos, sin (..., T, head_dim / 2)."""
    half = head_dim // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float32,
                                   device=positions.device) / half)
    ang = positions[..., None].to(torch.float32) * freq
    return torch.cos(ang), torch.sin(ang)


def rope_apply(x, cos, sin):
    """Rotate the split-half pairs (x1, x2). Exact for GaussianTensors: the
    rotation is a fixed linear map, so var' = var1 cos^2 + var2 sin^2 per
    pair."""
    cos, sin = cos.to(x.dtype), sin.to(x.dtype)
    if is_gaussian(x):
        m1, m2 = torch.chunk(x.mean, 2, dim=-1)
        v1, v2 = torch.chunk(x.var, 2, dim=-1)
        mean = torch.cat([m1 * cos - m2 * sin, m2 * cos + m1 * sin], -1)
        c2, s2 = torch.square(cos), torch.square(sin)
        var = torch.cat([v1 * c2 + v2 * s2, v2 * c2 + v1 * s2], -1)
        return GaussianTensor(mean, var, VAR)
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def sinusoidal_embedding(positions, d_model: int):
    half = d_model // 2
    freq = 1e4 ** (-torch.arange(half, dtype=torch.float32,
                                 device=positions.device) / half)
    ang = positions[..., None].to(torch.float32) * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# -- residual --------------------------------------------------------------------
def residual_add(x, y):
    if is_gaussian(x) or is_gaussian(y):
        return dispatch.pfp_residual(x, y)
    return x + y
