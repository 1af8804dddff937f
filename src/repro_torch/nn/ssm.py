"""Mamba2 / SSD (state-space duality) block with PFP moment propagation.

Counterpart of ``repro/nn/ssm.py``. The SSD algorithm (Dao & Gu, 2024)
computes the selective-SSM recurrence

    S_t = a_t S_{t-1} + dt_t (B_t ⊗ x_t)        a_t = exp(dt_t * A)  (A < 0)
    y_t = C_t · S_t + D ⊙ x_t

in chunks: quadratic attention-like products within a chunk and a linear
state pass across chunks.

PFP treatment: the selection coefficients (dt, A, B, C) and the gate z come
from Bayesian projections but enter the recurrence through the mean path
(the delta method); x carries (mu, var). Given the coefficients, y is
linear in x, so the means go through the chunked map with the coefficients
and the variances with their elementwise squares. The chunked map is plain
torch (``einsum``), as it is plain ``jnp`` outside any Pallas kernel in the
reference; the x slice's and the z gate's silu go through the
``activation`` op, the gate product through ``glu_product`` and the gated
norm through ``rmsnorm``.
"""
from __future__ import annotations

import types
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import dispatch
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.core.gaussian import VAR, GaussianTensor, is_gaussian
from repro_torch.nn.layers import dense_init, rmsnorm_apply
from repro_torch.nn.module import Context, frozen, init_bayes, resolve_weight


class SSMState(NamedTuple):
    s_mean: torch.Tensor     # (B, H, P, N)
    s_var: torch.Tensor      # (B, H, P, N)
    conv_mean: torch.Tensor  # (B, W-1, conv_dim)
    conv_srm: torch.Tensor   # (B, W-1, conv_dim)


class Mamba2(nn.Module):
    """``in_proj`` (D, 2 d_inner + 2 N + H: z, x, B, C, dt), ``out_proj``
    (d_inner, D), the Bayesian conv taps ``conv_w`` (W, d_inner + 2 N) and
    the plain ``a_log``, ``dt_bias``, ``d_skip`` (H,) and ``norm_g``
    (d_inner,). One group of B and C."""

    def __init__(self, d_model: int, *, d_state: int = 128, expand: int = 2,
                 head_dim: int = 64, conv_width: int = 4,
                 sigma_init: float = 1e-4,
                 generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(sigma_init=sigma_init, generator=generator, device=device)
        d_inner = expand * d_model
        heads = d_inner // head_dim
        self.in_proj = dense_init(d_model, 2 * d_inner + 2 * d_state + heads,
                                  **kw)
        self.out_proj = dense_init(d_inner, d_model, **kw)
        self.conv_w = init_bayes((conv_width, d_inner + 2 * d_state),
                                 fan_in=conv_width, **kw)
        self.a_log = frozen(torch.log(torch.linspace(
            1.0, 16.0, heads, dtype=torch.float32)).to(device))
        self.dt_bias = frozen(torch.zeros((heads,), device=device))
        self.d_skip = frozen(torch.ones((heads,), device=device))
        self.norm_g = frozen(torch.ones((d_inner,), device=device))


def _chunk(a, length: int):
    b, t = a.shape[:2]
    return a.reshape(b, t // length, length, *a.shape[2:])


def _ssd_scan(pack, x, s0):
    """The chunked SSD map, every coefficient deterministic.

    pack: (G, decay_out, decay_state, chunk_decay, Bc, Cc) with G (B, nc,
    H, L, L) the masked intra-chunk scores, decay_out (B, nc, H, L) exp(l_t),
    decay_state (B, nc, H, L) exp(l_L - l_s) dt_s, chunk_decay (B, nc, H)
    exp(l_L), Bc and Cc (B, nc, H, L, N). x (B, nc, H, L, P), s0 (B, H, P,
    N). Returns y (B, nc, H, L, P) and the final state."""
    g, decay_out, decay_state, chunk_decay, bc, cc = pack
    y_intra = torch.einsum("bchts,bchsp->bchtp", g, x)
    # Each chunk's own state: sum_s decay_state[s] (B_s ⊗ x_s).
    chunk_states = torch.einsum("bchs,bchsn,bchsp->bchpn", decay_state, bc, x)
    s, prevs = s0, []
    for c in range(x.shape[1]):       # the states before each chunk
        prevs.append(s)
        s = s * chunk_decay[:, c, :, None, None] + chunk_states[:, c]
    s_prevs = torch.stack(prevs, dim=1)                     # (B, nc, H, P, N)
    y_inter = torch.einsum("bchtn,bchpn,bcht->bchtp", cc, s_prevs, decay_out)
    return y_intra + y_inter, s


def mamba2_apply(block: Mamba2, x, ctx: Context, *, d_state: int = 128,
                 expand: int = 2, head_dim: int = 64, conv_width: int = 4,
                 chunk: int = 128, state: Optional[SSMState] = None):
    """x (B, T, D), plain or Gaussian; T a multiple of ``chunk``. Returns
    (out, new_state), new_state None unless ``state`` is given."""
    pfp = is_gaussian(x)
    d_inner = expand * x.shape[-1]
    heads = d_inner // head_dim

    proj = block.in_proj(x, ctx)
    mean = proj.mean if pfp else proj
    z_m, xin_m, b_m, c_m, dt_m = torch.split(
        mean, [d_inner, d_inner, d_state, d_state, heads], dim=-1)
    if pfp:
        z_v = proj.var[..., :d_inner]
        xin_v = proj.var[..., d_inner:2 * d_inner]

    # Causal depthwise conv over (x, B, C): Bayesian taps, the variance
    # kept for the x slice only (B and C enter through the mean path).
    conv_in_m = torch.cat([xin_m, b_m, c_m], dim=-1)
    w = resolve_weight(block.conv_w, ctx)
    w_mu = w.mean if isinstance(w, GaussianTensor) else w

    def taps(arr, prev):
        if prev is None:
            prev = arr.new_zeros((arr.shape[0], conv_width - 1)
                                 + arr.shape[2:])
        full = torch.cat([prev, arr], dim=1)
        t = arr.shape[1]
        return torch.stack([full[:, i:i + t] for i in range(conv_width)], 0)

    prev_m = None if state is None else state.conv_mean
    conv_m = F.silu(torch.einsum("wbtr,wr->btr", taps(conv_in_m, prev_m),
                                 w_mu))
    xin_m2 = conv_m[..., :d_inner]
    b_m2 = conv_m[..., d_inner:d_inner + d_state]
    c_m2 = conv_m[..., d_inner + d_state:]
    if pfp:
        # The x slice's variance through the conv (SRM form) and the silu's
        # moments.
        xin_srm = xin_v + torch.square(xin_m)
        prev_srm = None if state is None else state.conv_srm[..., :d_inner]
        prev_mm = None if state is None else state.conv_mean[..., :d_inner]
        w_x = w_mu[:, :d_inner]
        w_x_srm = (w.srm[:, :d_inner] if isinstance(w, GaussianTensor)
                   else torch.square(w_x))
        t_m = taps(xin_m, prev_mm)
        t_s = taps(xin_srm, prev_srm)
        pre_m = torch.einsum("wbtr,wr->btr", t_m, w_x)
        pre_v = (torch.einsum("wbtr,wr->btr", t_s, w_x_srm)
                 - torch.einsum("wbtr,wr->btr", torch.square(t_m),
                                torch.square(w_x)))
        act = dispatch.pfp_activation(
            GaussianTensor(pre_m, torch.clamp(pre_v, min=0.0), VAR), "silu",
            impl=ctx.impl)
        xin_gauss = act.to_var()
    # dt and the decays (mean path).
    dt = F.softplus(dt_m + block.dt_bias.to(dt_m.dtype))   # (B, T, H)
    log_a = dt * -torch.exp(block.a_log).to(dt.dtype)      # (B, T, H)

    batch, t_len = dt.shape[:2]
    if t_len % chunk:
        raise ValueError(f"seq len {t_len} not divisible by chunk {chunk}")
    nc = t_len // chunk

    la = _chunk(log_a, chunk).movedim(-1, 2)               # (B, nc, H, L)
    cum = torch.cumsum(la, dim=-1)                         # l_t
    seg = cum[..., :, None] - cum[..., None, :]            # l_t - l_s
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=dt.device))
    dtc = _chunk(dt, chunk).movedim(-1, 2)                 # (B, nc, H, L)
    shape = (batch, nc, heads, chunk, d_state)
    bc = _chunk(b_m2, chunk)[:, :, None].expand(shape)
    cc = _chunk(c_m2, chunk)[:, :, None].expand(shape)
    scores = torch.einsum("bchtn,bchsn->bchts", cc, bc)    # C_t . B_s
    # exp only on the causal entries: the masked (t < s) sums are positive
    # and would overflow.
    seg_safe = torch.where(tri, seg, torch.zeros_like(seg))
    g = (torch.where(tri, torch.exp(seg_safe), torch.zeros_like(seg))
         * scores * dtc[..., None, :])
    decay_out = torch.exp(cum)
    decay_state = torch.exp(cum[..., -1:] - cum) * dtc
    chunk_decay = torch.exp(cum[..., -1])                  # (B, nc, H)
    pack = (g, decay_out, decay_state, chunk_decay, bc, cc)

    def to_heads(arr):    # (B, T, d_inner) -> (B, nc, H, L, P)
        return _chunk(arr, chunk).reshape(
            batch, nc, chunk, heads, head_dim).movedim(3, 2)

    def from_heads(arr):
        return arr.movedim(2, 3).reshape(batch, t_len, d_inner)

    s0_shape = (batch, heads, head_dim, d_state)
    s0_m = (state.s_mean if state is not None
            else dt.new_zeros(s0_shape))
    d_skip = block.d_skip.to(dt.dtype)[:, None, None]     # (H, 1, 1)
    if pfp:
        xm, xv = to_heads(xin_gauss.mean), to_heads(xin_gauss.var)
        y_m, s_m = _ssd_scan(pack, xm, s0_m)
        # The variance: the same linear map with squared coefficients.
        s0_v = (state.s_var if state is not None
                else dt.new_zeros(s0_shape))
        y_v, s_v = _ssd_scan(tuple(torch.square(p) for p in pack), xv, s0_v)
        y_m = y_m + xm * d_skip
        y_v = y_v + xv * torch.square(d_skip)
        y = GaussianTensor(from_heads(y_m),
                           torch.clamp(from_heads(y_v), min=0.0), VAR)
        z_act = dispatch.pfp_activation(GaussianTensor(z_m, z_v, VAR), "silu",
                                        impl=ctx.impl)
        gated = dispatch.pfp_glu_product(z_act, y, impl=ctx.impl)
        normed = rmsnorm_apply(types.SimpleNamespace(g=block.norm_g),
                               gated.to_var(), ctx)
    else:
        xm = to_heads(xin_m2)
        y_m, s_m = _ssd_scan(pack, xm, s0_m)
        gated = F.silu(z_m) * from_heads(y_m + xm * d_skip)
        normed = rmsnorm_apply(types.SimpleNamespace(g=block.norm_g), gated,
                               ctx)
        s_v = None
    out = block.out_proj(normed, ctx)

    new_state = None
    if state is not None:
        keep = conv_width - 1
        # The rolling conv window: means always, the x slice's SRM under PFP.
        srm_in = (torch.cat([xin_srm, torch.square(b_m), torch.square(c_m)],
                            dim=-1) if pfp else torch.square(conv_in_m))
        new_state = SSMState(
            s_mean=s_m,
            s_var=s_v if s_v is not None else torch.zeros_like(s_m),
            conv_mean=torch.cat([state.conv_mean, conv_in_m],
                                dim=1)[:, -keep:],
            conv_srm=torch.cat([state.conv_srm, srm_in], dim=1)[:, -keep:])
    return out, new_state


def init_ssm_state(batch: int, d_model: int, *, d_state: int = 128,
                   expand: int = 2, head_dim: int = 64, conv_width: int = 4,
                   dtype=torch.float32, device: DeviceLike = None) -> SSMState:
    device = resolve_device(device)
    d_inner = expand * d_model
    s = (batch, d_inner // head_dim, head_dim, d_state)
    win = (batch, conv_width - 1, d_inner + 2 * d_state)
    return SSMState(*(torch.zeros(shape, dtype=dtype, device=device)
                      for shape in (s, s, win, win)))
