"""Decoder LM: the dense transformer (granite, llama-style), the
mixture-of-experts family (deepseek-moe, llama4-scout) and the audio decoder
(musicgen: frame embeddings in, LayerNorm, sinusoidal positions, MHA).

Counterpart of ``repro/models/lm.py`` for ``attn`` and ``moe`` blocks:
token embedding (or the ``frame_embeddings`` input where
``cfg.embed_inputs`` is false), leading dense-FFN layers (``head{i}``,
DeepSeekMoE's first layer), the stacked layer groups of ``cfg.pattern``,
an unstacked tail (``tail{i}``) where the layers do not tile, the final
norm and the LM head.
Every block is pre-norm: norm -> attention -> residual, norm -> MLP (or
MoE) -> residual. One set of Bayesian leaves serves DETERMINISTIC and PFP.

The reference scans the stacked groups (``params['stack']``, leading axis =
group); here they are an ``nn.ModuleList`` run by a Python loop, and
``load_numpy_params`` carries the stacked tree across.

The same definition serves three programs, as in the reference:

  forward()      full-sequence pass, optionally filling decode state
  prefill()      full-sequence pass into a fresh contiguous KV cache
  decode_step()  a step against per-layer decode state (one token, or a
                 chunk of tokens under a paged page table)

Decode state keeps the reference's tree: ``{'head0': KVCache, 'stack':
{'b0': KVCache}}``, stack leaves with a leading layer-group axis, so the
slot helpers work along the same axes (``_state_batch_axis``). Speculative
drafting and the recurrent, SSM and cross-attention blocks come with later
slices (ROADMAP.md).
"""
from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import DeviceLike, init_generator, resolve_device
from repro_torch.core.gaussian import GaussianTensor, is_gaussian
from repro_torch.core.modes import Mode
from repro_torch.nn.attention import (Attention, KVCache, PagedKVCache,
                                      attention_apply, init_kv_cache,
                                      init_paged_kv_cache)
from repro_torch.nn.layers import (NORMS, dense_init, embedding_init,
                                   residual_add, sinusoidal_embedding)
from repro_torch.nn.mlp import MLPBlock
from repro_torch.nn.module import Context
from repro_torch.nn.moe import MoE, moe_apply, zero_aux

FAMILIES = ("dense", "moe", "audio")


class Block(nn.Module):
    """One block: ``ln1``, ``attn``, ``ln2``, then ``mlp`` (kind ``attn``)
    or ``moe`` (kind ``moe``)."""

    def __init__(self, cfg: ModelConfig, kind: str, *, generator, device):
        super().__init__()
        self.kind = kind
        kw = dict(sigma_init=cfg.sigma_init, generator=generator,
                  device=device)
        self.ln1 = NORMS[cfg.norm](cfg.d_model, device=device)
        self.attn = Attention(cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                              cfg.head_dim, **kw)
        self.ln2 = NORMS[cfg.norm](cfg.d_model, device=device)
        if kind == "moe":
            self.moe = MoE(cfg.d_model, cfg.d_ff, cfg.num_experts,
                           num_shared=cfg.num_shared_experts,
                           gated=cfg.gated_mlp, **kw)
        else:
            self.mlp = MLPBlock(cfg.d_model, cfg.d_ff, gated=cfg.gated_mlp,
                                **kw)


def _group_counts(cfg: ModelConfig):
    """(blocks per group, stacked groups, tail layers) after the
    ``first_dense_layers`` head layers."""
    lpg = len(cfg.pattern)
    groups = (cfg.num_layers - cfg.first_dense_layers) // lpg
    tail = cfg.num_layers - cfg.first_dense_layers - groups * lpg
    return lpg, groups, tail


def _layers(cfg: ModelConfig):
    """Every layer in order: (name, kind, stack group or None). Stacked
    layers are named ``b{i}`` and sit in group ``g``; head and tail layers
    are named ``head{i}`` / ``tail{i}``."""
    lpg, groups, tail = _group_counts(cfg)
    out = [(f"head{i}", "attn", None) for i in range(cfg.first_dense_layers)]
    out += [(f"b{i}", cfg.pattern[i], g) for g in range(groups)
            for i in range(lpg)]
    out += [(f"tail{i}", cfg.pattern[i % lpg], None) for i in range(tail)]
    return out


class LM(nn.Module):
    """``embed`` (only where ``cfg.embed_inputs``), ``head{i}``, ``stack``
    (one group of ``cfg.pattern`` blocks each), ``tail{i}``, ``ln_f``,
    ``lm_head``: the reference's parameter paths."""

    def __init__(self, cfg: ModelConfig, *,
                 generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None):
        super().__init__()
        if cfg.family not in FAMILIES:
            raise NotImplementedError(
                f"the {cfg.family!r} family is not ported yet (ROADMAP.md)")
        device = resolve_device(device)
        g = init_generator(generator)
        self.cfg = cfg
        if cfg.embed_inputs:
            self.embed = embedding_init(cfg.vocab_size, cfg.d_model,
                                        sigma_init=cfg.sigma_init,
                                        generator=g, device=device)
        _, groups, _ = _group_counts(cfg)
        if groups:
            self.stack = nn.ModuleList(nn.ModuleDict() for _ in range(groups))
        for name, kind, group in _layers(cfg):
            block = Block(cfg, kind, generator=g, device=device)
            if group is None:
                setattr(self, name, block)
            else:
                self.stack[group][name] = block
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


def _block_apply(block: Block, x, ctx: Context, cfg: ModelConfig, *,
                 positions, standard_positions: bool, state=None,
                 cache_len=None, page_table=None, write_start=None,
                 moe_aux_loss: bool = True):
    """Returns (x, new_state, aux): aux is the MoE aux dict, zero for an
    ``attn`` block."""
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
    if block.kind == "moe":
        ffn_out, aux = moe_apply(
            block.moe, h, ctx, num_experts=cfg.num_experts, top_k=cfg.top_k,
            capacity_factor=cfg.capacity_factor, activation=cfg.activation,
            aux_loss=moe_aux_loss, dispatch_mode=cfg.moe_dispatch)
    else:
        ffn_out = block.mlp(h, ctx, activation=cfg.activation)
        aux = zero_aux(positions.device)
    return residual_add(x, ffn_out), new_state, aux


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
    """Token embedding, or the stub frontend's frame embeddings (a point
    mass under PFP), plus the sinusoid of ``arange(T)``: as in the
    reference, a decode step or a prefill chunk adds the embeddings of
    positions 0..T-1, not of its absolute positions."""
    device = resolve_device(ctx.device)
    if cfg.embed_inputs:
        tokens = _as_device(inputs["tokens"], device)
        b, t = tokens.shape
        x = model.embed(tokens, ctx)
    else:
        x = inputs["frame_embeddings"]
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.asarray(x))
        x = x.to(device)
        b, t = x.shape[:2]
        if ctx.mode == Mode.PFP:
            x = GaussianTensor.deterministic(x)
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
            states=None, collect_states: bool = False,
            moe_aux_loss: bool = True):
    """Full-sequence pass. ``inputs``: ``tokens`` (B, T), or
    ``frame_embeddings`` (B, T, d_model) where ``cfg.embed_inputs`` is
    false, and optionally ``positions`` (B, T); with decode ``states``,
    also ``cache_len`` (B,), and for paged states ``page_table`` (B, P)
    and ``write_start`` (B,). Returns ``(logits, aux, new_states)``: ``aux`` is the MoE aux dict
    summed over the blocks (``loss``, ``moe_dropped``,
    ``moe_assignments``); ``new_states`` is None unless ``collect_states``
    and ``states`` are given. ``moe_aux_loss=False`` is the inference path:
    the router's load-balance loss is never built."""
    x, positions, standard_positions = _embed_inputs(model, cfg, inputs, ctx)
    device = positions.device
    cache_len = _as_device(inputs.get("cache_len"), device)
    page_table = _as_device(inputs.get("page_table"), device)
    write_start = _as_device(inputs.get("write_start"), device)
    aux_total = zero_aux(device)
    new_top, new_stack = {}, {}   # head / tail caches; stacked per group
    for name, _, group in _layers(cfg):
        if group is None:
            block = getattr(model, name)
            st = None if states is None else states[name]
        else:
            block = model.stack[group][name]
            st = (None if states is None else type(states["stack"][name])(
                *(leaf[group] for leaf in states["stack"][name])))
        x, new_st, aux = _block_apply(
            block, x, ctx, cfg, positions=positions,
            standard_positions=standard_positions, state=st,
            cache_len=cache_len, page_table=page_table,
            write_start=write_start, moe_aux_loss=moe_aux_loss)
        aux_total = {k: aux_total[k] + aux[k] for k in aux_total}
        if st is not None and group is None:
            new_top[name] = new_st
        elif st is not None:
            new_stack.setdefault(name, []).append(new_st)
    x = model.ln_f(x, ctx)
    logits = model.lm_head(x, ctx)
    if is_gaussian(logits):
        # Under the fusion pass (core/dispatch.py) ln_f -> lm_head comes
        # back as a lazy pending; reading its fields runs it here, so no
        # kernel of this forward is left to run wherever the caller first
        # reads the logits.
        logits = GaussianTensor(logits.mean, logits.second, logits.rep)
    out_states = None
    if collect_states and states is not None:
        out_states = {**states, **new_top}
        if new_stack:
            out_states["stack"] = {
                name: type(per_group[0])(
                    *(torch.stack(leaves) for leaves in zip(*per_group)))
                for name, per_group in new_stack.items()}
    return logits, aux_total, out_states


# ---------------------------------------------------------------------------
# Decode state
# ---------------------------------------------------------------------------
def _stacked(cfg: ModelConfig, make) -> dict:
    """One cache per attention layer: ``head{i}`` / ``tail{i}`` entries
    batch-first, ``{'stack': {'b0': cache}}`` with a leading layer-group
    axis on every leaf."""
    _, groups, _ = _group_counts(cfg)
    states = {}
    for name, _, group in _layers(cfg):
        if group is None:
            states[name] = make()
        elif group == 0:
            proto = make()
            states.setdefault("stack", {})[name] = type(proto)(*(
                leaf.unsqueeze(0).repeat(groups, *([1] * leaf.dim()))
                for leaf in proto))
    return states


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int, *,
                      device: DeviceLike = None) -> dict:
    """Zeroed contiguous KV caches: (B, Hkv, max_len, Dh) leaves, with a
    leading layer-group axis under ``stack``."""
    device = resolve_device(device)
    return _stacked(cfg, lambda: init_kv_cache(
        batch, cfg.num_kv_heads, max_len, cfg.head_dim, device=device))


def init_paged_decode_state(cfg: ModelConfig, num_pages: int,
                            page_size: int, *,
                            device: DeviceLike = None) -> dict:
    """Paged decode state: each attention layer's cache is a pool of
    ``num_pages`` pages (page 0 the trash page), (NP, Hkv, page_size, Dh)
    leaves, with a leading layer-group axis under ``stack``. Which pages
    belong to which slot lives in the page tables of the decode inputs, so
    the tree has no slot axis. Every block the port has (``attn``,
    ``moe``) keeps an attention cache, so every model pages."""
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
    """A decode step. ``inputs``: ``tokens`` (B, T) (or
    ``frame_embeddings`` (B, T, d_model)), ``positions`` (B, T) absolute;
    optional ``cache_len`` (B,) valid cache entries including this step's
    tokens (entries at or past it are masked, and the paged
    insert sends their writes to the trash page); ``page_table`` (B, P)
    for states from :func:`init_paged_decode_state`; ``write_start`` (B,),
    the first position each row may write. Returns (logits, new_states)."""
    logits, _, new_states = decode_step_with_aux(model, cfg, inputs, states,
                                                 ctx)
    return logits, new_states


def decode_step_with_aux(model: LM, cfg: ModelConfig, inputs: Mapping,
                         states, ctx: Context):
    """:func:`decode_step` that also returns the MoE aux dict (the drop
    accounting a server reads per step; the load-balance loss stays 0).
    Returns (logits, aux, new_states)."""
    return forward(model, cfg, inputs, ctx, states=dict(states),
                   collect_states=True, moe_aux_loss=False)


def prefill(model: LM, cfg: ModelConfig, inputs: Mapping, ctx: Context,
            max_len: int):
    """Full-sequence pass into a fresh contiguous KV cache of ``max_len``
    rows. Returns (last-position logits (B, 1, V), states)."""
    batch = len(inputs["tokens"] if cfg.embed_inputs
                else inputs["frame_embeddings"])
    states = init_decode_state(cfg, batch, max_len, device=ctx.device)
    logits, _, new_states = forward(model, cfg, inputs, ctx, states=states,
                                    collect_states=True, moe_aux_loss=False)
    if is_gaussian(logits):
        last = GaussianTensor(logits.mean[:, -1:], logits.second[:, -1:],
                              logits.rep)
    else:
        last = logits[:, -1:]
    return last, new_states
