"""Decoder LM: the dense transformer (granite, yi, gemma, internlm2), the
mixture-of-experts family (deepseek-moe, llama4-scout), the VLM backbone
(llama-3.2-vision: cross-attention to stub image embeddings every
``cross_attn_every``-th layer), the audio decoder (musicgen: frame
embeddings in, LayerNorm, sinusoidal positions, MHA), the hybrid of RG-LRU
recurrent blocks and local attention (recurrentgemma) and the Mamba2
state-space model (mamba2).

Counterpart of ``repro/models/lm.py`` for every block kind (``attn``,
``cross``, ``moe``, ``rec``, ``ssm``): token embedding (or the
``frame_embeddings`` input where ``cfg.embed_inputs`` is false), leading
dense-FFN layers (``head{i}``, DeepSeekMoE's first layer), the stacked
layer groups of ``cfg.pattern``, an unstacked tail (``tail{i}``) where the
layers do not tile, the final norm and the LM head.
Every block is pre-norm: norm -> attention (or the recurrent block) ->
residual, norm -> MLP (or MoE) -> residual; a Mamba2 block is norm ->
SSD -> residual. A ``cross`` block attends, without rotary embedding or
causality, to the ``image_embeddings`` input (B, S, d_model), a point mass
under PFP. One set of Bayesian leaves serves DETERMINISTIC and PFP.

The reference scans the stacked groups (``params['stack']``, leading axis =
group); here they are an ``nn.ModuleList`` run by a Python loop, and
``load_numpy_params`` carries the stacked tree across.

The same definition serves three programs, as in the reference:

  forward()      full-sequence pass, optionally filling decode state
  prefill()      full-sequence pass into fresh contiguous decode state
  decode_step()  a step against per-layer decode state (one token, or a
                 chunk of tokens)

plus ``draft_decode_step()``, the mean-only pass that drafts tokens for
speculative decoding.

Decode state keeps the reference's tree: ``{'head0': KVCache, 'stack':
{'b0': RecurrentState, 'b2': KVCache}, 'tail0': SSMState}``, one entry a
layer (a KV cache, or the recurrent or SSM carry), stack leaves with a
leading layer-group axis, so the slot helpers work along the same axes
(``_state_batch_axis``). Only attention caches page. A ``cross`` block
holds no decode state on either pool: as in the reference, its K/V are
projected from the image embeddings again at every step.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core import mesh_route
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
from repro_torch.nn.pjit_hints import constrain, place_state
from repro_torch.nn.recurrent import (RGLRU, RecurrentState,
                                      init_recurrent_state, rglru_block_apply)
from repro_torch.nn.ssm import Mamba2, SSMState, init_ssm_state, mamba2_apply

FAMILIES = ("dense", "moe", "vlm", "audio", "hybrid", "ssm")
_STATES = {cls.__name__: cls for cls in (KVCache, PagedKVCache,
                                          RecurrentState, SSMState)}


class Block(nn.Module):
    """One block: ``ln1``, then ``attn`` (kinds ``attn``, ``cross`` and
    ``moe``), ``rec`` (the RG-LRU block) or ``ssm`` (Mamba2); all but
    ``ssm`` then ``ln2`` and ``mlp`` (``moe`` for kind ``moe``)."""

    def __init__(self, cfg: ModelConfig, kind: str, *, generator, device):
        super().__init__()
        self.kind = kind
        kw = dict(sigma_init=cfg.sigma_init, generator=generator,
                  device=device)
        self.ln1 = NORMS[cfg.norm](cfg.d_model, device=device)
        if kind == "ssm":
            self.ssm = Mamba2(cfg.d_model, d_state=cfg.ssm_state,
                              expand=cfg.ssm_expand,
                              head_dim=cfg.ssm_head_dim, **kw)
            return
        if kind == "rec":
            self.rec = RGLRU(cfg.d_model, cfg.d_rnn or cfg.d_model, **kw)
        else:
            self.attn = Attention(cfg.d_model, cfg.num_heads,
                                  cfg.num_kv_heads, cfg.head_dim, **kw)
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
                 positions, standard_positions: bool, image_emb=None,
                 state=None, cache_len=None, page_table=None,
                 write_start=None, moe_aux_loss: bool = True):
    """Returns (x, new_state, aux): aux is the MoE aux dict, zero for every
    block but ``moe``. A ``cross`` block attends to ``image_emb`` and
    returns no state."""
    h = block.ln1(x, ctx)
    if block.kind == "ssm":
        out, new_state = mamba2_apply(
            block.ssm, h, ctx, d_state=cfg.ssm_state, expand=cfg.ssm_expand,
            head_dim=cfg.ssm_head_dim, chunk=min(cfg.ssm_chunk, x.shape[1]),
            state=state)
        return residual_add(x, out), new_state, zero_aux(positions.device)
    if block.kind == "rec":
        out, new_state = rglru_block_apply(block.rec, h, ctx, state=state)
    elif block.kind == "cross":
        out, new_state = attention_apply(
            block.attn, h, ctx, num_heads=cfg.num_heads,
            num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
            positions=positions, causal=False, rope_theta=None,
            cross_kv=image_emb, standard_positions=standard_positions)
    else:
        out, new_state = attention_apply(
            block.attn, h, ctx, num_heads=cfg.num_heads,
            num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
            positions=positions, causal=True, window=cfg.window or None,
            rope_theta=cfg.rope_theta if cfg.positional == "rope" else None,
            cache=state, cache_len=cache_len, page_table=page_table,
            write_start=write_start, standard_positions=standard_positions)
    x = residual_add(x, out)
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


def _embeddings(value, device):
    """A stub frontend's embeddings (tensor or numpy array) as a tensor on
    ``device``, in their own dtype."""
    if not isinstance(value, torch.Tensor):
        value = torch.from_numpy(np.asarray(value))
    return value.to(device)


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
        x = _embeddings(inputs["frame_embeddings"], device)
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
    false, and optionally ``positions`` (B, T); for a VLM,
    ``image_embeddings`` (B, S, d_model); with decode ``states``, also
    ``cache_len`` (B,), and for paged states ``page_table`` (B, P) and
    ``write_start`` (B,). Returns ``(logits, aux, new_states)``: ``aux`` is
    the MoE aux dict summed over the blocks (``loss``, ``moe_dropped``,
    ``moe_assignments``); ``new_states`` is None unless ``collect_states``
    and ``states`` are given. ``moe_aux_loss=False`` is the inference path:
    the router's load-balance loss is never built."""
    x, positions, standard_positions = _embed_inputs(model, cfg, inputs, ctx)
    x = constrain(x, "batch", "seq", "embed")
    device = positions.device
    image_emb = inputs.get("image_embeddings")
    if image_emb is not None:
        image_emb = _embeddings(image_emb, device)
        if ctx.mode == Mode.PFP:
            image_emb = GaussianTensor.deterministic(image_emb)
    cache_len = _as_device(inputs.get("cache_len"), device)
    page_table = _as_device(inputs.get("page_table"), device)
    write_start = _as_device(inputs.get("write_start"), device)
    aux_total = zero_aux(device)
    new_top, new_stack = {}, {}   # head / tail caches; stacked per group
    for name, _, group in _layers(cfg):
        if group is None:
            block = getattr(model, name)
            st = None if states is None else states.get(name)
        else:
            block = model.stack[group][name]
            stacked = (None if states is None
                       else states["stack"].get(name))
            st = (None if stacked is None else type(stacked)(
                *(leaf[group] for leaf in stacked)))
            if name == "b0":   # the head of a stacked group's body
                x = constrain(x, "batch", "seq", "embed")
        x, new_st, aux = _block_apply(
            block, x, ctx, cfg, positions=positions,
            standard_positions=standard_positions, image_emb=image_emb,
            state=st, cache_len=cache_len, page_table=page_table,
            write_start=write_start, moe_aux_loss=moe_aux_loss)
        aux_total = {k: aux_total[k] + aux[k] for k in aux_total}
        if st is not None and group is None:
            new_top[name] = new_st
        elif st is not None:
            new_stack.setdefault(name, []).append(new_st)
    x = model.ln_f(x, ctx)
    x = constrain(x, "batch", "seq", "embed")
    logits = model.lm_head(x, ctx)
    logits = constrain(logits, "batch", "seq", "vocab")
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
    """One state per layer, ``make(kind)``: ``head{i}`` / ``tail{i}``
    entries batch-first, ``{'stack': {'b0': state}}`` with a leading
    layer-group axis on every leaf. A ``cross`` layer has none."""
    _, groups, _ = _group_counts(cfg)
    states = {}
    for name, kind, group in _layers(cfg):
        if kind == "cross":
            continue
        if group is None:
            states[name] = make(kind)
        elif group == 0:
            proto = make(kind)
            states.setdefault("stack", {})[name] = type(proto)(*(
                leaf.unsqueeze(0).repeat(groups, *([1] * leaf.dim()))
                for leaf in proto))
    return states


def _placed_state(states, mesh):
    """``states`` placed by the decode-state rules on a live ``mesh``
    (``launch.sharding.state_shardings``), or as they are without one."""
    if mesh is None:
        return states
    from repro_torch.launch import sharding

    return sharding.distribute_tree(
        states, sharding.state_shardings(states, mesh), mesh)


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int, *,
                      device: DeviceLike = None, mesh=None) -> dict:
    """Zeroed contiguous decode state: a KV cache of (B, Hkv, max_len, Dh)
    leaves for each attention layer, a ``RecurrentState`` or ``SSMState``
    carry for each recurrent or SSM layer, nothing for a cross-attention
    layer; a leading layer-group axis under ``stack``. With a live
    ``mesh``: DTensors placed by the decode-state rules."""
    device = resolve_device(device)

    def make(kind):
        if kind == "rec":
            return init_recurrent_state(batch, cfg.d_rnn or cfg.d_model,
                                        device=device)
        if kind == "ssm":
            return init_ssm_state(batch, cfg.d_model, d_state=cfg.ssm_state,
                                  expand=cfg.ssm_expand,
                                  head_dim=cfg.ssm_head_dim, device=device)
        return init_kv_cache(batch, cfg.num_kv_heads, max_len, cfg.head_dim,
                             device=device)

    return _placed_state(_stacked(cfg, make), mesh)


def init_paged_decode_state(cfg: ModelConfig, num_pages: int,
                            page_size: int, *, device: DeviceLike = None,
                            mesh=None) -> dict:
    """Paged decode state: each attention layer's cache is a pool of
    ``num_pages`` pages (page 0 the trash page), (NP, Hkv, page_size, Dh)
    leaves, with a leading layer-group axis under ``stack`` (none for a
    cross-attention layer). Which pages belong to which slot lives in the
    page tables of the decode inputs, so the tree has no slot axis. Only
    attention-family models page: a recurrent or SSM carry has no
    positional validity mask, so it cannot share a lockstep-written global
    pool (such models keep the contiguous layout). With a live ``mesh``:
    DTensors placed by the decode-state rules, as :func:`prefill` places
    a contiguous state."""
    bad = sorted({k for k in cfg.pattern if k not in ("attn", "moe",
                                                       "cross")})
    if bad:
        raise ValueError(
            f"paged decode state supports attention-family models only; "
            f"{cfg.name} has block kinds {bad}")
    device = resolve_device(device)
    return _placed_state(_stacked(cfg, lambda kind: init_paged_kv_cache(
        num_pages, cfg.num_kv_heads, page_size, cfg.head_dim,
        device=device)), mesh)


def load_numpy_decode_state(tree, device: DeviceLike = None):
    """A decode-state tree of numpy arrays (the reference's, after
    ``np.asarray`` on each leaf) as the port's tensors on ``device``:
    dicts stay dicts, a ``KVCache``, ``PagedKVCache``, ``RecurrentState``
    or ``SSMState`` becomes the port's class of the same name."""
    device = resolve_device(device)
    if isinstance(tree, Mapping):
        return {k: load_numpy_decode_state(v, device) for k, v in tree.items()}
    cls = _STATES.get(type(tree).__name__)
    if cls is not None:
        return cls(*(torch.tensor(np.asarray(a), device=device)
                     for a in tree))
    return torch.tensor(np.asarray(tree), device=device)


def _state_batch_axis(path) -> int:
    """Slot (batch) axis of a decode-state leaf: leaves under ``stack``
    carry a leading layer-group axis (batch is axis 1); head and tail
    leaves put batch first."""
    return 1 if path[0] == "stack" else 0


def _map_with_path(fn, tree, *rest, path=()):
    """Apply ``fn(path, leaf, *other_leaves)`` over dicts and state tuples
    (KV caches and the recurrent and SSM carries)."""
    if isinstance(tree, Mapping):
        return {k: _map_with_path(fn, v, *(r[k] for r in rest),
                                  path=path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, tuple(_STATES.values())):
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


def _sharded(leaf) -> bool:
    return mesh_route.has_dtensor((leaf,))


def take_decode_slots(states, idx):
    """Gather per-slot decode state along the slot axis; the result's
    batch is ``len(idx)`` (a slot's view for a prefill, or a permutation
    that compacts the slot pool: one gather per leaf, on the device). On a
    mesh the slot axis is gathered first (``mesh_route.take_rows``): a
    permutation may move rows across data ranks. That happens on
    compaction, defrag and a slot's view, not at every step."""
    def take(path, leaf):
        ax = _state_batch_axis(path)
        if _sharded(leaf):
            return mesh_route.take_rows(leaf, ax, _index(idx, "cpu"))
        return leaf.index_select(ax, _index(idx, leaf.device))
    return _map_with_path(take, states)


def write_decode_slot(states, slot: int, sub):
    """Write a single-slot substate (batch 1) into the pool at ``slot``:
    the inverse of ``take_decode_slots(states, [slot])``. Out of place.
    On a mesh only the rank holding the slot writes, in its own block."""
    def wr(path, leaf, sub_leaf):
        ax = _state_batch_axis(path)
        if _sharded(leaf):
            rows = mesh_route.rows_like(sub_leaf, leaf, ax)
            return mesh_route.update_rows(
                leaf, ax, _index([slot], "cpu"),
                lambda local, at, sel: local.index_copy(
                    ax, at, rows.index_select(ax, sel).to(local.dtype)))
        return leaf.index_copy(ax, _index([slot], leaf.device),
                               sub_leaf.to(leaf.dtype))
    return _map_with_path(wr, states, sub)


def reset_decode_slot(states, slot: int):
    """Zero one slot's decode state, so a newly allocated request never
    sees the previous occupant's (on a mesh, on the rank holding it)."""
    def rz(path, leaf):
        ax = _state_batch_axis(path)
        if _sharded(leaf):
            return mesh_route.update_rows(
                leaf, ax, _index([slot], "cpu"),
                lambda local, at, sel: local.index_fill(ax, at, 0))
        return leaf.index_fill(ax, _index([slot], leaf.device), 0)
    return _map_with_path(rz, states)


def copy_decode_pages(states, src, dst):
    """Copy page-pool rows ``src`` onto rows ``dst`` of a paged decode
    state: the device half of a copy-on-write. One gather and one scatter
    per leaf; the Gaussian KV triple never visits the host. On a mesh the
    source pages are gathered (they may live on another data rank) and
    each destination page is written by the rank that holds it."""
    def cp(path, leaf):
        ax = _state_batch_axis(path)
        if _sharded(leaf):
            rows = mesh_route.rows_like(
                mesh_route.take_rows(leaf, ax, _index(src, "cpu")), leaf, ax)
            return mesh_route.update_rows(
                leaf, ax, _index(dst, "cpu"),
                lambda local, at, sel: local.index_copy(
                    ax, at, rows.index_select(ax, sel)))
        rows = leaf.index_select(ax, _index(src, leaf.device))
        return leaf.index_copy(ax, _index(dst, leaf.device), rows)
    return _map_with_path(cp, states)


def select_decode_slots(new_states, old_states, keep_new):
    """Per-slot merge: ``keep_new`` (B,) bool takes the new slot state
    where True and the old one where False (a lockstep step advances every
    slot; parked slots keep their old state). On a mesh each rank merges
    its own slots."""
    def sel(path, new, old):
        ax = _state_batch_axis(path)
        keep = torch.as_tensor(keep_new, device=new.device, dtype=torch.bool)
        if _sharded(old):
            return mesh_route.select_rows(new, old, ax, keep)
        shape = [1] * new.dim()
        shape[ax] = new.shape[ax]
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
    the first position each row may write; for a VLM, ``image_embeddings``
    (B, S, d_model) at every step. Returns (logits, new_states)."""
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


def draft_decode_step(model: LM, cfg: ModelConfig, inputs: Mapping, states,
                      ctx: Optional[Context] = None):
    """Mean-only (zero-variance) decode pass for speculative drafting:
    :func:`decode_step` in ``Mode.DETERMINISTIC``, every weight at its
    posterior mean and no variance propagated. On a Gaussian KV pool it
    writes rows with ``v_var = 0``; the caller discards ``new_states``, so
    no such row ever reaches a served computation (the verify pass re-feeds
    the drafted tokens through the PFP pass). Returns ``(mean_logits,
    new_states)``, ``mean_logits`` a plain (B, T, V) tensor."""
    dctx = (dataclasses.replace(ctx, mode=Mode.DETERMINISTIC)
            if ctx is not None else Context(mode=Mode.DETERMINISTIC))
    logits, new_states = decode_step(model, cfg, inputs, states, dctx)
    if is_gaussian(logits):
        logits = logits.mean
    return logits, new_states


def prefill(model: LM, cfg: ModelConfig, inputs: Mapping, ctx: Context,
            max_len: int):
    """Full-sequence pass into fresh contiguous decode state (KV caches of
    ``max_len`` rows, recurrent and SSM carries). Returns (last-position
    logits (B, 1, V), states)."""
    first = (inputs["tokens"] if cfg.embed_inputs
             else inputs["frame_embeddings"])
    states = init_decode_state(cfg, len(first), max_len, device=ctx.device)
    if mesh_route.has_dtensor((first,)):
        states = place_state(states)   # on a mesh: split as the rules say
    logits, _, new_states = forward(model, cfg, inputs, ctx, states=states,
                                    collect_states=True, moe_aux_loss=False)
    if is_gaussian(logits):
        last = GaussianTensor(logits.mean[:, -1:], logits.second[:, -1:],
                              logits.rep)
    else:
        last = logits[:, -1:]
    return last, new_states
