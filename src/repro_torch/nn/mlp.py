"""Feed-forward blocks, plain and gated (SwiGLU / GeGLU).

Counterpart of ``repro/nn/mlp.py``: ``w_up``, ``w_down`` and, when gated,
``w_gate``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.core.device import DeviceLike
from repro_torch.nn.layers import activation_apply, dense_init, glu_apply
from repro_torch.nn.module import Context


class MLPBlock(nn.Module):
    def __init__(self, d_model: int, d_ff: int, *, gated: bool = True,
                 sigma_init: float = 1e-4,
                 generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None):
        super().__init__()
        kw = dict(sigma_init=sigma_init, generator=generator, device=device)
        self.w_up = dense_init(d_model, d_ff, **kw)
        self.w_down = dense_init(d_ff, d_model, **kw)
        self.w_gate = dense_init(d_model, d_ff, **kw) if gated else None

    def forward(self, x, ctx: Context, *, activation: str = "silu"):
        return mlp_apply(self, x, ctx, activation=activation)


def mlp_apply(block: MLPBlock, x, ctx: Context, *, activation: str = "silu"):
    up = block.w_up(x, ctx)
    if block.w_gate is not None:
        h = glu_apply(block.w_gate(x, ctx), up, activation, ctx)
    else:
        h = activation_apply(up, activation, ctx)
    return block.w_down(h, ctx)
