"""Decoder LM: the dense transformer family (granite, llama-style).

Counterpart of ``repro/models/lm.py`` for ``attn`` blocks: token embedding,
a stack of pre-norm blocks (norm -> attention -> residual, norm -> MLP ->
residual), the final norm and the LM head. One set of Bayesian leaves
serves DETERMINISTIC and PFP.

The reference scans a stacked layer group (``params['stack']``, leading
axis = layer); here the layers are an ``nn.ModuleList`` of groups run by a
Python loop, and ``load_numpy_params`` carries the stacked tree across.

The same definition serves three programs, as in the reference:

  forward()      full-sequence pass, optionally filling decode state
  prefill()      full-sequence pass into a fresh contiguous KV cache
  decode_step()  a step against per-layer decode state (one token, or a
                 chunk of tokens under a paged page table)

Decode state keeps the reference's tree: ``{'stack': {'b0': KVCache}}``,
every leaf with a leading layer-group axis, so the slot helpers work along
the same axes (``_state_batch_axis``). Speculative drafting and the MoE,
recurrent, SSM and cross-attention blocks come with later slices
(ROADMAP.md).
"""
from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import DeviceLike, init_generator, resolve_device
from repro_torch.core.gaussian import GaussianTensor, is_gaussian
from repro_torch.nn.attention import (Attention, KVCache, PagedKVCache,
                                      attention_apply, init_kv_cache,
                                      init_paged_kv_cache)
from repro_torch.nn.layers import (NORMS, dense_init, embedding_init,
                                   residual_add, sinusoidal_embedding)
from repro_torch.nn.mlp import MLPBlock
from repro_torch.nn.module import Context


class Block(nn.Module):
    """One ``attn`` block: ``ln1``, ``attn``, ``ln2``, ``mlp``."""

    def __init__(self, cfg: ModelConfig, *, generator, device):
        super().__init__()
        kw = dict(sigma_init=cfg.sigma_init, generator=generator,
                  device=device)
        self.ln1 = NORMS[cfg.norm](cfg.d_model, device=device)
        self.attn = Attention(cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                              cfg.head_dim, **kw)
        self.ln2 = NORMS[cfg.norm](cfg.d_model, device=device)
        self.mlp = MLPBlock(cfg.d_model, cfg.d_ff, gated=cfg.gated_mlp, **kw)


class LM(nn.Module):
    """``embed``, ``stack`` (one group of ``cfg.pattern`` blocks per
    layer), ``ln_f``, ``lm_head``: the reference's parameter paths."""

    def __init__(self, cfg: ModelConfig, *,
                 generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None):
        super().__init__()
        if cfg.family != "dense":
            raise NotImplementedError(
                f"the {cfg.family!r} family is not ported yet (ROADMAP.md)")
        device = resolve_device(device)
        g = init_generator(generator)
        self.cfg = cfg
        self.embed = embedding_init(cfg.vocab_size, cfg.d_model,
                                    sigma_init=cfg.sigma_init, generator=g,
                                    device=device)
        self.stack = nn.ModuleList(
            nn.ModuleDict({f"b{i}": Block(cfg, generator=g, device=device)
                           for i in range(len(cfg.pattern))})
            for _ in range(cfg.num_layers // len(cfg.pattern)))
        self.ln_f = NORMS[cfg.norm](cfg.d_model, device=device)
        self.lm_head = dense_init(cfg.d_model, cfg.vocab_size,
                                  sigma_init=cfg.sigma_init, generator=g,
                                  device=device)

    def forward(self, inputs: Mapping, ctx: Context):
        return forward(self, self.cfg, inputs, ctx)


def init_params(cfg: ModelConfig, *,
                generator: Optional[torch.Generator] = None,
                device: DeviceLike = None) -> LM:
    """Random variational weights (draws on ``generator``'s device; a CPU
    generator seeded with 0 when none is given)."""
    return LM(cfg, generator=generator, device=device)


def zero_aux(device) -> dict:
    """The MoE aux dict the reference's forward returns; zero for dense
    blocks."""
    z = torch.zeros((), dtype=torch.float32, device=device)
    return {"loss": z, "moe_dropped": z, "moe_assignments": z}


def _block_apply(block: Block, x, ctx: Context, cfg: ModelConfig, *,
                 positions, standard_positions: bool, state=None,
                 cache_len=None, page_table=None, write_start=None):
    """Returns (x, new_state)."""
    h = block.ln1(x, ctx)
    attn_out, new_state = attention_apply(
        block.attn, h, ctx, num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
        positions=positions, causal=True, window=cfg.window or None,
        rope_theta=cfg.rope_theta if cfg.positional == "rope" else None,
        cache=state, cache_len=cache_len, page_table=page_table,
        write_start=write_start, standard_positions=standard_positions)
    x = residual_add(x, attn_out)
    h = block.ln2(x, ctx)
    return residual_add(x, block.mlp(h, ctx, activation=cfg.activation)), \
        new_state


def _as_device(value, device, dtype=torch.long):
    """A decode input (tensor, numpy array or list) as a tensor on
    ``device``; None stays None."""
    if value is None:
        return None
    if not isinstance(value, torch.Tensor):
        value = torch.from_numpy(np.array(value))
    return value.to(device=device, dtype=dtype)


def _embed_inputs(model: LM, cfg: ModelConfig, inputs: Mapping,
                  ctx: Context):
    device = resolve_device(ctx.device)
    tokens = _as_device(inputs["tokens"], device)
    b, t = tokens.shape
    x = model.embed(tokens, ctx)
    if cfg.positional == "sinusoidal":
        pos_emb = sinusoidal_embedding(torch.arange(t, device=device),
                                       cfg.d_model).to(x.dtype)
        x = (residual_add(x, pos_emb.expand(b, t, cfg.d_model))
             if is_gaussian(x) else x + pos_emb)
    # Whether the positions are the default 0..T-1 (the caller gave none)
    # decides if the kernel's index-based causal mask applies.
    standard_positions = "positions" not in inputs
    if standard_positions:
        positions = torch.arange(t, device=device).expand(b, t)
    else:
        positions = _as_device(inputs["positions"], device)
    return x, positions, standard_positions


def forward(model: LM, cfg: ModelConfig, inputs: Mapping, ctx: Context, *,
            states=None, collect_states: bool = False):
    """Full-sequence pass. ``inputs``: ``tokens`` (B, T) and optionally
    ``positions`` (B, T); with decode ``states``, also ``cache_len`` (B,),
    and for paged states ``page_table`` (B, P) and ``write_start`` (B,).
    Returns ``(logits, aux, new_states)``: ``aux`` is the MoE aux dict,
    zero for dense blocks; ``new_states`` is None unless
    ``collect_states`` and ``states`` are given."""
    x, positions, standard_positions = _embed_inputs(model, cfg, inputs, ctx)
    device = positions.device
    cache_len = _as_device(inputs.get("cache_len"), device)
    page_table = _as_device(inputs.get("page_table"), device)
    write_start = _as_device(inputs.get("write_start"), device)
    stack = None if states is None else states["stack"]
    new_stack = {}
    for layer, group in enumerate(model.stack):
        for i in range(len(cfg.pattern)):
            name = f"b{i}"
            st = (None if stack is None
                  else type(stack[name])(*(leaf[layer]
                                           for leaf in stack[name])))
            x, new_st = _block_apply(
                group[name], x, ctx, cfg, positions=positions,
                standard_positions=standard_positions, state=st,
                cache_len=cache_len, page_table=page_table,
                write_start=write_start)
            if st is not None:
                new_stack.setdefault(name, []).append(new_st)
    x = model.ln_f(x, ctx)
    logits = model.lm_head(x, ctx)
    out_states = None
    if collect_states and states is not None:
        out_states = dict(states)
        out_states["stack"] = {
            name: type(stack[name])(*(torch.stack(leaves) for leaves in
                                      zip(*per_layer)))
            for name, per_layer in new_stack.items()}
    return logits, zero_aux(logits.mean.device if is_gaussian(logits)
                            else logits.device), out_states


# ---------------------------------------------------------------------------
# Decode state
# ---------------------------------------------------------------------------
def _stacked(cfg: ModelConfig, make) -> dict:
    """``{'stack': {'b0': cache}}`` with a leading layer-group axis on
    every leaf; the dense family has no head or tail layers."""
    groups = cfg.num_layers // len(cfg.pattern)
    proto = make()
    return {"stack": {"b0": type(proto)(*(
        leaf.unsqueeze(0).repeat(groups, *([1] * leaf.dim()))
        for leaf in proto))}}


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int, *,
                      device: DeviceLike = None) -> dict:
    """Zeroed contiguous KV caches, (groups, B, Hkv, max_len, Dh) leaves."""
    device = resolve_device(device)
    return _stacked(cfg, lambda: init_kv_cache(
        batch, cfg.num_kv_heads, max_len, cfg.head_dim, device=device))


def init_paged_decode_state(cfg: ModelConfig, num_pages: int,
                            page_size: int, *,
                            device: DeviceLike = None) -> dict:
    """Paged decode state: each attention layer's cache is a pool of
    ``num_pages`` pages (page 0 the trash page), (groups, NP, Hkv,
    page_size, Dh) leaves. Which pages belong to which slot lives in the
    page tables of the decode inputs, so the tree has no slot axis."""
    device = resolve_device(device)
    return _stacked(cfg, lambda: init_paged_kv_cache(
        num_pages, cfg.num_kv_heads, page_size, cfg.head_dim, device=device))


def load_numpy_decode_state(tree, device: DeviceLike = None):
    """A decode-state tree of numpy arrays (the reference's, after
    ``np.asarray`` on each leaf) as the port's tensors on ``device``:
    dicts stay dicts, a ``KVCache`` or ``PagedKVCache`` becomes the port's
    class of the same name."""
    device = resolve_device(device)
    if isinstance(tree, Mapping):
        return {k: load_numpy_decode_state(v, device) for k, v in tree.items()}
    name = type(tree).__name__
    if name in ("KVCache", "PagedKVCache"):
        cls = KVCache if name == "KVCache" else PagedKVCache
        return cls(*(torch.tensor(np.asarray(a), device=device)
                     for a in tree))
    return torch.tensor(np.asarray(tree), device=device)


def _state_batch_axis(path) -> int:
    """Slot (batch) axis of a decode-state leaf: leaves under ``stack``
    carry a leading layer-group axis (batch is axis 1); head and tail
    leaves put batch first."""
    return 1 if path[0] == "stack" else 0


def _map_with_path(fn, tree, *rest, path=()):
    """Apply ``fn(path, leaf, *other_leaves)`` over dicts and cache
    tuples."""
    if isinstance(tree, Mapping):
        return {k: _map_with_path(fn, v, *(r[k] for r in rest),
                                  path=path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (KVCache, PagedKVCache)):
        return type(tree)(*(_map_with_path(fn, v, *(r[i] for r in rest),
                                           path=path + (i,))
                            for i, v in enumerate(tree)))
    return fn(path, tree, *rest)


def _index(idx, device):
    """Slot or page indices (int, list, numpy or tensor) as a 1-D long
    tensor on ``device``."""
    if not isinstance(idx, torch.Tensor):
        idx = torch.as_tensor(np.asarray(idx))
    return idx.to(device=device, dtype=torch.long).reshape(-1)


def take_decode_slots(states, idx):
    """Gather per-slot decode state along the slot axis; the result's
    batch is ``len(idx)`` (a slot's view for a prefill, or a permutation
    that compacts the slot pool: one gather per leaf, on the device)."""
    def take(path, leaf):
        return leaf.index_select(_state_batch_axis(path),
                                 _index(idx, leaf.device))
    return _map_with_path(take, states)


def write_decode_slot(states, slot: int, sub):
    """Write a single-slot substate (batch 1) into the pool at ``slot``:
    the inverse of ``take_decode_slots(states, [slot])``. Out of place."""
    def wr(path, leaf, sub_leaf):
        return leaf.index_copy(_state_batch_axis(path),
                               _index([slot], leaf.device),
                               sub_leaf.to(leaf.dtype))
    return _map_with_path(wr, states, sub)


def reset_decode_slot(states, slot: int):
    """Zero one slot's decode state, so a newly allocated request never
    sees the previous occupant's."""
    def rz(path, leaf):
        return leaf.index_fill(_state_batch_axis(path),
                               _index([slot], leaf.device), 0)
    return _map_with_path(rz, states)


def copy_decode_pages(states, src, dst):
    """Copy page-pool rows ``src`` onto rows ``dst`` of a paged decode
    state: the device half of a copy-on-write. One gather and one scatter
    per leaf; the Gaussian KV triple never visits the host."""
    def cp(path, leaf):
        ax = _state_batch_axis(path)
        rows = leaf.index_select(ax, _index(src, leaf.device))
        return leaf.index_copy(ax, _index(dst, leaf.device), rows)
    return _map_with_path(cp, states)


def select_decode_slots(new_states, old_states, keep_new):
    """Per-slot merge: ``keep_new`` (B,) bool takes the new slot state
    where True and the old one where False (a lockstep step advances every
    slot; parked slots keep their old state)."""
    def sel(path, new, old):
        ax = _state_batch_axis(path)
        shape = [1] * new.dim()
        shape[ax] = new.shape[ax]
        keep = torch.as_tensor(keep_new, device=new.device, dtype=torch.bool)
        return torch.where(keep.reshape(shape), new, old)
    return _map_with_path(sel, new_states, old_states)


def decode_step(model: LM, cfg: ModelConfig, inputs: Mapping, states,
                ctx: Context):
    """A decode step. ``inputs``: ``tokens`` (B, T), ``positions`` (B, T)
    absolute; optional ``cache_len`` (B,) valid cache entries including
    this step's tokens (entries at or past it are masked, and the paged
    insert sends their writes to the trash page); ``page_table`` (B, P)
    for states from :func:`init_paged_decode_state`; ``write_start`` (B,),
    the first position each row may write. Returns (logits, new_states)."""
    logits, _, new_states = decode_step_with_aux(model, cfg, inputs, states,
                                                 ctx)
    return logits, new_states


def decode_step_with_aux(model: LM, cfg: ModelConfig, inputs: Mapping,
                         states, ctx: Context):
    """:func:`decode_step` that also returns the MoE aux dict.
    Returns (logits, aux, new_states)."""
    return forward(model, cfg, inputs, ctx, states=dict(states),
                   collect_states=True)


def prefill(model: LM, cfg: ModelConfig, inputs: Mapping, ctx: Context,
            max_len: int):
    """Full-sequence pass into a fresh contiguous KV cache of ``max_len``
    rows. Returns (last-position logits (B, 1, V), states)."""
    states = init_decode_state(cfg, len(inputs["tokens"]), max_len,
                               device=ctx.device)
    logits, _, new_states = forward(model, cfg, inputs, ctx, states=states,
                                    collect_states=True)
    if is_gaussian(logits):
        last = GaussianTensor(logits.mean[:, -1:], logits.second[:, -1:],
                              logits.rep)
    else:
        last = logits[:, -1:]
    return last, new_states
