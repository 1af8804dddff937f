"""The paper's evaluation models: MLP (784-100-100-10) and LeNet-5.

Counterpart of ``repro/models/simple.py``. Both run DETERMINISTIC, SVI
(the deterministic ops on sampled weights, differentiable for training)
and PFP over one set of Bayesian leaves; images are NHWC and conv weights
HWIO at the public functions, as in the reference. Random initialisation
draws from a ``torch.Generator`` (a fresh CPU one seeded with 0 when none
is given) on its own device, and the weights are then moved to
``device``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import dispatch
from repro_torch.core.device import DeviceLike, init_generator, resolve_device
from repro_torch.core.gaussian import GaussianTensor, is_gaussian
from repro_torch.nn.layers import activation_apply, bias_init, dense_init
from repro_torch.nn.module import BayesParam, Context, init_bayes, resolve_weight


def _input(x, ctx: Context, dtype: torch.dtype) -> torch.Tensor:
    """The deterministic input as a tensor of the weights' dtype."""
    return torch.as_tensor(x, dtype=dtype, device=resolve_device(ctx.device))


class MLP(nn.Module):
    """``dense0 .. dense{num_hidden}`` with ReLU between them."""

    def __init__(self, *, d_in: int = 784, d_hidden: int = 100,
                 d_out: int = 10, num_hidden: int = 2,
                 sigma_init: float = 1e-4,
                 generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None):
        super().__init__()
        g = init_generator(generator)
        dims = [d_in] + [d_hidden] * num_hidden + [d_out]
        self.num_hidden = num_hidden
        for i in range(num_hidden + 1):
            self.add_module(f"dense{i}", dense_init(
                dims[i], dims[i + 1], sigma_init=sigma_init, bias=True,
                generator=g, device=device))

    def forward(self, x, ctx: Context):
        """x: (B, d_in) deterministic input -> logits (tensor or Gaussian)."""
        # deterministic: the first PFP layer uses Eq. 13
        h = _input(x, ctx, self.dense0.w.mu.dtype)
        for i in range(self.num_hidden):
            h = getattr(self, f"dense{i}")(h, ctx)
            h = activation_apply(h, "relu", ctx)
        return getattr(self, f"dense{self.num_hidden}")(h, ctx)


class Conv2d(nn.Module):
    """A Bayesian conv layer: HWIO weight ``w``, bias ``b``."""

    def __init__(self, w: BayesParam, b: BayesParam):
        super().__init__()
        self.w = w
        self.b = b

    def forward(self, x, ctx: Context, *, padding: str = "SAME"):
        return conv_apply(self, x, ctx, padding=padding)


def conv_init(kh: int, kw: int, cin: int, cout: int, *,
              sigma_init: float = 1e-4,
              generator: Optional[torch.Generator] = None,
              device: DeviceLike = None) -> Conv2d:
    w = init_bayes((kh, kw, cin, cout), generator=generator,
                   fan_in=kh * kw * cin, sigma_init=sigma_init, device=device)
    return Conv2d(w, bias_init(cout, sigma_init=sigma_init, device=device))


def conv_apply(layer: Conv2d, x, ctx: Context, *, padding: str = "SAME"):
    w = resolve_weight(layer.w, ctx)
    b = resolve_weight(layer.b, ctx)
    if isinstance(w, GaussianTensor):
        return dispatch.pfp_conv2d_im2col(x, w, b, padding=padding,
                                          formulation=ctx.formulation,
                                          impl=ctx.impl)
    xm = x.mean if is_gaussian(x) else x
    y = F.conv2d(xm.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                 padding=padding.lower())
    return y.permute(0, 2, 3, 1) + b


def _maxpool(x, ctx: Context):
    if is_gaussian(x):
        return dispatch.pfp_maxpool2d(x, impl=ctx.impl)
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


class LeNet5(nn.Module):
    """conv0 (5x5, 6) - pool - conv1 (5x5, 16) - pool - 120 - 84 - classes."""

    def __init__(self, *, num_classes: int = 10, in_channels: int = 1,
                 sigma_init: float = 1e-4,
                 generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None):
        super().__init__()
        g = init_generator(generator)
        kw = dict(sigma_init=sigma_init, generator=g, device=device)
        self.conv0 = conv_init(5, 5, in_channels, 6, **kw)
        self.conv1 = conv_init(5, 5, 6, 16, **kw)
        self.dense0 = dense_init(16 * 7 * 7, 120, bias=True, **kw)
        self.dense1 = dense_init(120, 84, bias=True, **kw)
        self.dense2 = dense_init(84, num_classes, bias=True, **kw)

    def forward(self, x, ctx: Context):
        """x: (B, 28, 28, in_channels) deterministic images."""
        x = _input(x, ctx, self.conv0.w.mu.dtype)
        h = self.conv0(x, ctx)                   # (B, 28, 28, 6)
        h = activation_apply(h, "relu", ctx)
        h = _maxpool(h, ctx)                     # (B, 14, 14, 6)
        h = self.conv1(h, ctx)                   # (B, 14, 14, 16)
        h = activation_apply(h, "relu", ctx)
        h = _maxpool(h, ctx)                     # (B, 7, 7, 16)
        h = h.reshape(h.shape[0], -1)
        h = self.dense0(h, ctx)
        h = activation_apply(h, "relu", ctx)
        h = self.dense1(h, ctx)
        h = activation_apply(h, "relu", ctx)
        return self.dense2(h, ctx)
