"""Decoder LM: the dense transformer family (granite, llama-style).

Counterpart of ``repro/models/lm.py`` for ``attn`` blocks: token embedding,
a stack of pre-norm blocks (norm -> attention -> residual, norm -> MLP ->
residual), the final norm and the LM head. One set of Bayesian leaves
serves DETERMINISTIC and PFP.

The reference scans a stacked layer group (``params['stack']``, leading
axis = layer); here the layers are an ``nn.ModuleList`` of groups run by a
Python loop, and ``load_numpy_params`` carries the stacked tree across.
Decode state, prefill and the MoE, recurrent, SSM and cross-attention
blocks come with later slices (ROADMAP.md).
"""
from __future__ import annotations

from typing import Mapping, Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import DeviceLike, init_generator, resolve_device
from repro_torch.core.gaussian import is_gaussian
from repro_torch.nn.attention import Attention, attention_apply
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
                 positions, standard_positions: bool):
    h = block.ln1(x, ctx)
    attn_out = attention_apply(
        block.attn, h, ctx, num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
        positions=positions, causal=True, window=cfg.window or None,
        rope_theta=cfg.rope_theta if cfg.positional == "rope" else None,
        standard_positions=standard_positions)
    x = residual_add(x, attn_out)
    h = block.ln2(x, ctx)
    return residual_add(x, block.mlp(h, ctx, activation=cfg.activation))


def _embed_inputs(model: LM, cfg: ModelConfig, inputs: Mapping,
                  ctx: Context):
    device = resolve_device(ctx.device)
    tokens = torch.as_tensor(inputs["tokens"], device=device).long()
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
        positions = torch.as_tensor(inputs["positions"], device=device).long()
    return x, positions, standard_positions


def forward(model: LM, cfg: ModelConfig, inputs: Mapping, ctx: Context):
    """Full-sequence pass. ``inputs``: ``tokens`` (B, T) and optionally
    ``positions`` (B, T). Returns ``(logits, aux, None)`` as the reference
    does without decode state; ``aux`` is zero for dense blocks."""
    x, positions, standard_positions = _embed_inputs(model, cfg, inputs, ctx)
    for group in model.stack:
        for i in range(len(cfg.pattern)):
            x = _block_apply(group[f"b{i}"], x, ctx, cfg, positions=positions,
                             standard_positions=standard_positions)
    x = model.ln_f(x, ctx)
    logits = model.lm_head(x, ctx)
    return logits, zero_aux(logits.mean.device if is_gaussian(logits)
                            else logits.device), None
