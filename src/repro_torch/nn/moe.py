"""Mixture-of-experts with capacity-based scatter dispatch.

Counterpart of ``repro/nn/moe.py`` (DeepSeekMoE / Llama-4 style): optional
shared experts always run; routed experts receive tokens by top-k routing
with a capacity limit:

    buf  = zeros(E, C, d); buf[expert_id, slot] = x   # dispatch
    out  = expert_mlp(buf)                             # batched (E, C, d)
    y    = sum_k out[expert_id, slot] * gate           # gather + combine

Under PFP the router works on the *mean* (control flow never sees a
distribution), so one set of indices serves the mean and the SRM buffers,
and the gate combine is affine: mean * g, var * g^2. The expert MLP is the
registry's ``dense_batched`` op (one kernel launch over all experts).

Dispatch and combine are deterministic: dispatch writes only the kept
assignments, whose (expert, slot) pairs are unique; combine sums each
token's K contributions in order k = 0 .. K-1. No atomics, so the same
inputs give the same bits on every run.

The expert MLP is told how many leading rows of each expert's buffer hold
a token, so at decode the kernel skips the rest (a 4-slot step fills at
most 24 of 64 experts); the rows it skips are zero and give exact zeros
either way, so ``empty_expert_skip(False)`` changes no bit.

``dispatch_mode='a2a'`` is the reference's explicit all-to-all over a mesh;
without one the reference runs the scatter path, and the port has no mesh
yet, so both modes run the scatter path here.
"""
from __future__ import annotations

import contextlib
from typing import List, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import dispatch
from repro_torch.core.device import DeviceLike, init_generator
from repro_torch.core.gaussian import SRM, VAR, GaussianTensor, is_gaussian
from repro_torch.nn.layers import activation_apply, dense_init, glu_apply
from repro_torch.nn.mlp import MLPBlock, mlp_apply
from repro_torch.nn.module import Context, init_bayes, resolve_weight

DISPATCH_MODES = ("scatter", "a2a")
_TOKEN_CHUNK = 32768  # tokens per routing call: bounds the dispatch buffers


class Experts(nn.Module):
    """The routed experts' stacked weights: ``w_up``, ``w_gate`` (gated)
    and ``w_down``, Bayesian leaves of shape (E, d_in, d_out)."""

    def __init__(self, d_model: int, d_ff: int, num_experts: int, *,
                 gated: bool, sigma_init: float, generator, device):
        super().__init__()
        kw = dict(sigma_init=sigma_init, generator=generator, device=device)
        self.w_up = init_bayes((num_experts, d_model, d_ff), fan_in=d_model,
                               **kw)
        self.w_down = init_bayes((num_experts, d_ff, d_model), fan_in=d_ff,
                                 **kw)
        self.w_gate = (init_bayes((num_experts, d_model, d_ff),
                                  fan_in=d_model, **kw) if gated else None)


class MoE(nn.Module):
    """The reference's ``moe_init`` tree: ``router`` (a dense d_model -> E),
    ``experts`` and, with ``num_shared``, ``shared``: one MLP of width
    ``d_ff * num_shared``."""

    def __init__(self, d_model: int, d_ff: int, num_experts: int, *,
                 num_shared: int = 0,
                 gated: bool = True, sigma_init: float = 1e-4,
                 generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None):
        super().__init__()
        g = init_generator(generator)
        kw = dict(sigma_init=sigma_init, generator=g, device=device)
        self.router = dense_init(d_model, num_experts, **kw)
        self.experts = Experts(d_model, d_ff, num_experts, gated=gated, **kw)
        self.shared = (MLPBlock(d_model, d_ff * num_shared, gated=gated, **kw)
                       if num_shared else None)


def zero_aux(device) -> dict:
    """The aux dict every MoE forward returns (and non-MoE blocks mirror):
    the Switch-style load-balance loss plus the drop accounting."""
    z = torch.zeros((), dtype=torch.float32, device=device)
    return {"loss": z, "moe_dropped": z, "moe_assignments": z}


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------
class Routing(NamedTuple):
    """One routing decision over S tokens and their K assignments."""

    probs: torch.Tensor       # (S, E) router softmax of the mean
    expert_idx: torch.Tensor  # (S, K) chosen experts, best first
    gate: torch.Tensor        # (S, K) their probabilities, renormalised
    keep: torch.Tensor        # (S*K,) bool: the assignment fits capacity
    slot: torch.Tensor        # (S*K,) its row in the expert's buffer
    capacity: int


_ROUTE_LOG: Optional[List[Routing]] = None
_SKIP_EMPTY = True


@contextlib.contextmanager
def empty_expert_skip(enabled: bool):
    """Inside the ``with`` block, pass (``True``, the default) or do not
    pass the expert MLP each expert's kept-row count."""
    global _SKIP_EMPTY
    outer, _SKIP_EMPTY = _SKIP_EMPTY, enabled
    try:
        yield
    finally:
        _SKIP_EMPTY = outer


@contextlib.contextmanager
def record_routing():
    """Collect the :class:`Routing` of every MoE call made inside the
    ``with`` block, in call order (tensors stay on their device)."""
    global _ROUTE_LOG
    log: List[Routing] = []
    outer, _ROUTE_LOG = _ROUTE_LOG, log
    try:
        yield log
    finally:
        _ROUTE_LOG = outer


def top_k_lower_index(values: torch.Tensor, k: int):
    """``torch.topk`` over the last axis with exact ties broken towards the
    lower index, as ``jax.lax.top_k`` does (``torch.topk`` on CUDA promises
    no order): a stable descending sort."""
    vals, idx = torch.sort(values, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def top_k_margin(probs: torch.Tensor, k: int) -> torch.Tensor:
    """Per token, the k-th minus the (k+1)-th largest probability: how far
    the routing is from a tie (inf when every expert is chosen)."""
    if k >= probs.shape[-1]:
        return torch.full(probs.shape[:-1], float("inf"), device=probs.device)
    vals, _ = torch.sort(probs, dim=-1, descending=True)
    return vals[..., k - 1] - vals[..., k]


def route(mean: torch.Tensor, router_mu: torch.Tensor, *, num_experts: int,
          top_k: int, capacity_factor: float) -> Routing:
    """Top-k routing of the (S, d) token means with a capacity per expert
    of ``max(top_k, round(S * top_k * capacity_factor / E))``. Slots come
    from one token-major cumulative count, so the assignments past
    capacity (the later tokens') drop."""
    s = mean.shape[0]
    probs = torch.softmax(mean @ router_mu, dim=-1)
    gate, expert_idx = top_k_lower_index(probs, top_k)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    capacity = int(max(top_k, round(s * top_k * capacity_factor
                                    / num_experts)))
    onehot = F.one_hot(expert_idx.reshape(-1), num_experts)   # (S*K, E)
    pos = ((torch.cumsum(onehot, dim=0) - 1) * onehot).sum(-1)
    keep = pos < capacity
    slot = torch.where(keep, pos, capacity - 1)
    routing = Routing(probs, expert_idx, gate, keep, slot, capacity)
    if _ROUTE_LOG is not None:
        _ROUTE_LOG.append(routing)
    return routing


# ---------------------------------------------------------------------------
# The expert MLP
# ---------------------------------------------------------------------------
def _expert_dense(param, x, ctx: Context, rows=None):
    """Batched per-expert contraction (E, C, d_in) x (E, d_in, d_out);
    ``rows``: None or each expert's kept-row count (int32, (E,))."""
    w = resolve_weight(param, ctx)
    if isinstance(w, GaussianTensor):
        return dispatch.pfp_dense_batched(x, w, formulation=ctx.formulation,
                                          impl=ctx.impl, rows=rows)
    return torch.bmm(x.mean if is_gaussian(x) else x, w)


def _expert_mlp(experts: Experts, x, ctx: Context, activation: str,
                rows=None):
    up = _expert_dense(experts.w_up, x, ctx, rows)
    if experts.w_gate is not None:
        h = glu_apply(_expert_dense(experts.w_gate, x, ctx, rows), up,
                      activation, ctx)
    else:
        h = activation_apply(up, activation, ctx)
    return _expert_dense(experts.w_down, h, ctx, rows)


# ---------------------------------------------------------------------------
# The block
# ---------------------------------------------------------------------------
def moe_apply(block: MoE, x, ctx: Context, *, num_experts: int, top_k: int,
              capacity_factor: float = 1.25, activation: str = "silu",
              aux_loss: bool = True, dispatch_mode: str = "scatter"):
    """x: (B, T, d) tensor or GaussianTensor. Returns (the same kind, aux
    dict with 'loss' / 'moe_dropped' / 'moe_assignments' fp32 scalars).

    ``aux_loss=False`` is the inference path: the load-balance loss is
    never built and stays 0; the drop accounting is always returned.

    More than ``_TOKEN_CHUNK`` tokens, in a multiple of it, are routed in
    chunks of that size (capacity is then per chunk), as the reference's
    scan does: the loss averages over the chunks, the drop counts add."""
    if dispatch_mode not in DISPATCH_MODES:
        raise ValueError(f"unknown dispatch_mode {dispatch_mode!r}")
    kw = dict(num_experts=num_experts, top_k=top_k,
              capacity_factor=capacity_factor, activation=activation,
              aux_loss=aux_loss)
    pfp = is_gaussian(x)
    mean_all = x.mean if pfp else x
    b, t, d = mean_all.shape
    s_total = b * t
    if not (s_total > _TOKEN_CHUNK and s_total % _TOKEN_CHUNK == 0):
        return _moe_tokens(block, x, ctx, **kw)
    nc = s_total // _TOKEN_CHUNK
    means = mean_all.reshape(nc, 1, _TOKEN_CHUNK, d)
    srms = x.srm.reshape(nc, 1, _TOKEN_CHUNK, d) if pfp else None
    total = zero_aux(mean_all.device)
    outs = []
    for i in range(nc):
        chunk = GaussianTensor(means[i], srms[i], SRM) if pfp else means[i]
        out, aux = _moe_tokens(block, chunk, ctx, **kw)
        total = {k: total[k] + aux[k] for k in total}
        outs.append(out)
    total["loss"] = total["loss"] / nc
    if pfp:
        return GaussianTensor(
            torch.cat([o.mean for o in outs]).reshape(b, t, d),
            torch.cat([o.var for o in outs]).reshape(b, t, d), VAR), total
    return torch.cat(outs).reshape(b, t, d), total


def _moe_tokens(block: MoE, x, ctx: Context, *, num_experts: int, top_k: int,
                capacity_factor: float, activation: str, aux_loss: bool):
    pfp = is_gaussian(x)
    mean_in = x.mean if pfp else x
    b, t, d = mean_in.shape
    s = b * t
    device = mean_in.device

    router_w = resolve_weight(block.router.w, ctx)
    router_mu = (router_w.mean if isinstance(router_w, GaussianTensor)
                 else router_w)
    r = route(mean_in.reshape(s, d), router_mu, num_experts=num_experts,
              top_k=top_k, capacity_factor=capacity_factor)
    flat_e = r.expert_idx.reshape(-1)                              # (S*K,)
    token_of = torch.arange(s * top_k, device=device) // top_k     # (S*K,)
    # Kept assignments write their own row; dropped ones all land on one
    # spare row past the buffer, which is cut off.
    rows = torch.where(r.keep, flat_e * r.capacity + r.slot,
                       num_experts * r.capacity)

    def scatter(flat):                                   # (S, d) -> (E, C, d)
        buf = flat.new_zeros((num_experts * r.capacity + 1, d))
        buf[rows] = flat[token_of]
        return buf[:-1].view(num_experts, r.capacity, d)

    if pfp:
        expert_in = GaussianTensor(scatter(mean_in.reshape(s, d)),
                                   scatter(x.srm.reshape(s, d)), SRM)
    else:
        expert_in = scatter(mean_in.reshape(s, d))
    # Each expert's kept rows are its slots 0 .. count - 1 (slots are one
    # token-major count). Counted on the device: no host sync.
    kept = (torch.zeros(num_experts, dtype=torch.int32, device=device)
            .scatter_add_(0, flat_e, r.keep.int()) if _SKIP_EMPTY else None)
    expert_out = _expert_mlp(block.experts, expert_in, ctx, activation, kept)

    keep_f = r.keep.to(mean_in.dtype)
    gate_flat = r.gate.reshape(-1) * keep_f                        # (S*K,)

    def combine(buf, weight):                            # (E, C, d) -> (S, d)
        parts = (buf[flat_e, r.slot] * weight[:, None]).reshape(s, top_k, d)
        y = parts[:, 0]
        for k in range(1, top_k):
            y = y + parts[:, k]
        return y

    if pfp:
        routed = GaussianTensor(
            combine(expert_out.mean, gate_flat).reshape(b, t, d),
            combine(expert_out.var, torch.square(gate_flat)).reshape(b, t, d),
            VAR)
    else:
        routed = combine(expert_out, gate_flat).reshape(b, t, d)

    if block.shared is not None:
        shared = mlp_apply(block.shared, x, ctx, activation=activation)
        if pfp:
            routed = GaussianTensor(routed.mean + shared.mean,
                                    routed.var + shared.var, VAR)
        else:
            routed = routed + shared

    # The Switch-style load-balance loss, for training; the inference path
    # (aux_loss=False) never builds it.
    if aux_loss:
        density = F.one_hot(r.expert_idx[:, 0], num_experts).to(
            torch.float32).mean(0)
        loss = num_experts * torch.sum(density * r.probs.mean(0))
    else:
        loss = torch.zeros((), dtype=torch.float32, device=device)
    # torch.full, not torch.tensor: no host-to-device copy, so a forward
    # can be captured in a CUDA graph.
    assignments = torch.full((), float(s * top_k), dtype=torch.float32,
                             device=device)
    aux = {"loss": loss,
           "moe_dropped": assignments - keep_f.to(torch.float32).sum(),
           "moe_assignments": assignments}
    return routed, aux
