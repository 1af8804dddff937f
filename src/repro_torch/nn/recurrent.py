"""RG-LRU recurrent block (Griffin / RecurrentGemma) with PFP moments.

Counterpart of ``repro/nn/recurrent.py``. Block layout (De et al., 2024):

    x-branch: Dense(D -> R) -> causal depthwise Conv1d(4) -> RG-LRU
    y-branch: Dense(D -> R) -> GeLU
    out     : Dense(R -> D) applied to (x-branch * y-branch)

RG-LRU recurrence (per channel):

    r_t = sigmoid(W_r u_t);  i_t = sigmoid(W_i u_t)
    a_t = exp(-c * softplus(Lambda) * r_t)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)

Under PFP the gates (r, i) come from the mean path (the delta method), so
the recurrence is affine in u and the moments go through the linear scan
exactly:

    mean: h_t = a_t h_{t-1} + b_t mu_u       (b = sqrt(1-a^2) * i)
    var : v_t = a_t^2 v_{t-1} + b_t^2 var_u

The scan is log-depth, a doubling scan of log2 T elementwise rounds (the
reference runs ``jax.lax.associative_scan``). The depthwise conv is a
Bayesian compute layer: the registry's ``einsum`` op in the SRM
formulation, which the kernel impl lifts onto the batched dense kernel.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import dispatch
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.core.gaussian import SRM, VAR, GaussianTensor, is_gaussian
from repro_torch.nn.layers import activation_apply, dense_init
from repro_torch.nn.module import Context, frozen, init_bayes, resolve_weight

_C = 8.0  # Griffin's recurrence-gate temperature


class RecurrentState(NamedTuple):
    h_mean: torch.Tensor     # (B, R)
    h_var: torch.Tensor      # (B, R)
    conv_mean: torch.Tensor  # (B, W-1, R) rolling conv window
    conv_srm: torch.Tensor   # (B, W-1, R)


class RGLRU(nn.Module):
    """Projections ``w_x``, ``w_y`` (D, R), ``w_out`` (R, D), gates
    ``w_r``, ``w_i`` (R, R), the Bayesian conv taps ``conv_w`` (W, R) and
    the plain recurrence parameter ``lam`` (R,)."""

    def __init__(self, d_model: int, d_rnn: int, *, conv_width: int = 4,
                 sigma_init: float = 1e-4,
                 generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None):
        super().__init__()
        kw = dict(sigma_init=sigma_init, generator=generator, device=device)
        self.w_x = dense_init(d_model, d_rnn, **kw)
        self.w_y = dense_init(d_model, d_rnn, **kw)
        self.w_out = dense_init(d_rnn, d_model, **kw)
        self.conv_w = init_bayes((conv_width, d_rnn), fan_in=conv_width, **kw)
        self.w_r = dense_init(d_rnn, d_rnn, **kw)
        self.w_i = dense_init(d_rnn, d_rnn, **kw)
        # Lambda so that a lies in [0.9, 0.999] at r = 1 (Griffin's
        # appendix).
        a = torch.linspace(0.9, 0.999, d_rnn, dtype=torch.float32)
        self.lam = frozen(torch.log(torch.expm1(-torch.log(a) / _C)).to(
            resolve_device(device)))


def _shift_stack(arr, prev, width: int):
    """(B, T, R) -> (W, B, T, R): tap i holds the inputs i - (W - 1) steps
    back, ``prev`` (B, W-1, R) (zeros when None) before the first."""
    if prev is None:
        prev = arr.new_zeros((arr.shape[0], width - 1) + arr.shape[2:])
    full = torch.cat([prev.to(arr.dtype), arr], dim=1)   # (B, T+W-1, R)
    t = arr.shape[1]
    return torch.stack([full[:, i:i + t] for i in range(width)], dim=0)


def _causal_depthwise_conv(u, conv_param, ctx: Context, state_mean=None,
                           state_srm=None):
    """Bayesian causal depthwise conv over time; u (B, T, R), plain or
    Gaussian. ``state_*`` (the previous W-1 inputs) is prepended on the
    decode path; zeros otherwise."""
    w = resolve_weight(conv_param, ctx)
    width = (w.mean if isinstance(w, GaussianTensor) else w).shape[0]
    if isinstance(w, GaussianTensor):
        taps = GaussianTensor(_shift_stack(u.mean, state_mean, width),
                              _shift_stack(u.srm, state_srm, width), SRM)
        return dispatch.pfp_einsum("wbtr,wr->btr", taps, w, impl=ctx.impl)
    return torch.einsum("wbtr,wr->btr", _shift_stack(u, state_mean, width), w)


def _linear_scan(a, u, h0=None):
    """h_t = a_t h_{t-1} + u_t along axis 1 (h_{-1} = h0, or 0): a doubling
    scan, log2 T rounds of the associative combine (a_l, u_l) . (a_r, u_r)
    = (a_l a_r, u_l a_r + u_r), each round combining step t with step
    t - shift."""
    if h0 is not None:
        u = torch.cat([u[:, :1] + a[:, :1] * h0[:, None], u[:, 1:]], dim=1)
    shift = 1
    while shift < a.shape[1]:
        u = torch.cat([u[:, :shift], u[:, :-shift] * a[:, shift:]
                       + u[:, shift:]], dim=1)
        a = torch.cat([a[:, :shift], a[:, :-shift] * a[:, shift:]], dim=1)
        shift *= 2
    return u


def _mean_weight(param, ctx: Context):
    w = resolve_weight(param, ctx)
    return w.mean if isinstance(w, GaussianTensor) else w


def rglru_block_apply(block: RGLRU, x, ctx: Context, *,
                      state: Optional[RecurrentState] = None):
    """The recurrent block. x (B, T, D), plain or Gaussian. Returns (out,
    new_state), new_state None unless ``state`` is given."""
    pfp = is_gaussian(x)
    u = block.w_x(x, ctx)                                   # (B, T, R)
    y = block.w_y(x, ctx)
    if pfp:
        u = u.to_srm()
        conv_out = _causal_depthwise_conv(
            u, block.conv_w, ctx,
            state_mean=None if state is None else state.conv_mean,
            state_srm=None if state is None else state.conv_srm)
    else:
        conv_out = _causal_depthwise_conv(
            u, block.conv_w, ctx,
            state_mean=None if state is None else state.conv_mean)

    # Gates from the mean path (the delta method under PFP).
    gate_in = conv_out.mean if pfp else conv_out
    r = torch.sigmoid(gate_in @ _mean_weight(block.w_r.w, ctx))
    i = torch.sigmoid(gate_in @ _mean_weight(block.w_i.w, ctx))
    a = torch.exp(-_C * F.softplus(block.lam).to(r.dtype) * r)   # (B, T, R)
    b = torch.sqrt(torch.clamp(1.0 - torch.square(a), min=1e-12)) * i

    if pfp:
        h = GaussianTensor(
            _linear_scan(a, b * conv_out.mean,
                         None if state is None else state.h_mean),
            _linear_scan(torch.square(a), torch.square(b) * conv_out.var,
                         None if state is None else state.h_var),
            VAR)
        y_act = dispatch.pfp_activation(y, "gelu", impl=ctx.impl)  # VAR->SRM
        merged = dispatch.pfp_glu_product(y_act, h, impl=ctx.impl)
    else:
        h = _linear_scan(a, b * conv_out,
                         None if state is None else state.h_mean)
        merged = activation_apply(y, "gelu", ctx) * h
    out = block.w_out(merged, ctx)

    new_state = None
    if state is not None:
        keep = block.conv_w.shape[0] - 1
        u_mean = u.mean if pfp else u
        u_srm = u.srm if pfp else torch.square(u)
        h_last = (h.mean if pfp else h)[:, -1]
        new_state = RecurrentState(
            h_mean=h_last,
            h_var=h.var[:, -1] if pfp else torch.zeros_like(h_last),
            conv_mean=torch.cat([state.conv_mean, u_mean], dim=1)[:, -keep:],
            conv_srm=torch.cat([state.conv_srm, u_srm], dim=1)[:, -keep:])
    return out, new_state


def init_recurrent_state(batch: int, d_rnn: int, conv_width: int = 4,
                         dtype=torch.float32,
                         device: DeviceLike = None) -> RecurrentState:
    device = resolve_device(device)
    vec = (batch, d_rnn)
    win = (batch, conv_width - 1, d_rnn)
    return RecurrentState(*(torch.zeros(s, dtype=dtype, device=device)
                            for s in (vec, vec, win, win)))
