"""Mode-polymorphic layers: dense and activations.

Counterpart of the dense and activation half of ``repro/nn/layers.py``.
DETERMINISTIC runs plain torch ops on the weight means; PFP routes every
moment-propagating op through the registry (``core/dispatch.py``), so
``ctx.impl`` selects the eager ops or the kernels per forward.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from repro_torch.core import dispatch
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.core.gaussian import GaussianTensor, is_gaussian
from repro_torch.core.pfp_layers import DETERMINISTIC_ACTIVATIONS
from repro_torch.nn.module import BayesParam, Context, init_bayes, resolve_weight


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
