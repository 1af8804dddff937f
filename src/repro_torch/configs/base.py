"""Model configuration (counterpart of ``repro/configs/base.py``).

What the port's decoder families need: the dense transformer (granite), the
mixture-of-experts family (deepseek-moe, llama4-scout), the audio decoder
(musicgen, whose frame embeddings come in as input: ``embed_inputs``), the
hybrid of RG-LRU recurrent blocks and local attention (recurrentgemma) and
the Mamba2 state-space model (mamba2) and the VLM backbone
(llama-3.2-vision: every ``cross_attn_every``-th layer cross-attends to
``num_image_tokens`` image embeddings from a stub frontend), whose
``models/lm.py`` blocks are ported.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | vlm | audio | hybrid | ssm | mlp | cnn
    num_layers: int
    d_model: int
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    activation: str = "silu"
    gated_mlp: bool = True
    norm: str = "rmsnorm"
    positional: str = "rope"         # rope | sinusoidal | none
    rope_theta: float = 1e4

    # MoE
    num_experts: int = 0
    top_k: int = 0
    num_shared_experts: int = 0
    first_dense_layers: int = 0      # leading dense-FFN layers (DeepSeekMoE)
    capacity_factor: float = 1.25
    # 'scatter' | 'a2a'. The port has no mesh yet, so 'a2a' runs the
    # scatter dispatch, as the reference does without one (nn/moe.py).
    moe_dispatch: str = "scatter"

    # VLM (backbone only; the vision frontend is a stub whose embeddings
    # come in as ``image_embeddings``)
    cross_attn_every: int = 0        # every Nth layer is a cross-attn layer
    num_image_tokens: int = 0

    # Hybrid (RG-LRU): block_pattern tiles to num_layers, the rest is an
    # unstacked tail.
    block_pattern: Tuple[str, ...] = ("attn",)
    window: int = 0                  # local attention window (0 = global)
    d_rnn: int = 0

    # SSM (Mamba2 SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 128

    # Modality frontend: False => the inputs are precomputed embeddings
    # (``frame_embeddings``, musicgen) and the model has no token table.
    embed_inputs: bool = True
    sigma_init: float = 1e-4
    sub_quadratic: bool = False      # can run long_500k

    @property
    def attn_dim(self) -> int:
        return self.num_heads * self.head_dim

    def _weights(self, experts: int) -> int:
        """Weights (means only) with ``experts`` routed experts counted per
        MoE block: embedding (where the model embeds tokens), blocks
        (attention, MLP or router, routed and shared experts, a
        cross-attention block counted as a self-attention one; the RG-LRU's
        projections, gates and conv taps; Mamba2's in and out projections),
        lm head."""
        d, kv = self.d_model, self.num_kv_heads * self.head_dim
        mlp = (3 if self.gated_mlp else 2) * d * self.d_ff
        n = (2 if self.embed_inputs else 1) * self.vocab_size * d
        for i in range(self.num_layers):
            kind = self.layer_kind(i)
            if kind in ("attn", "cross", "moe"):
                n += 2 * d * self.attn_dim + 2 * d * kv
            if kind == "moe":
                n += ((experts + self.num_shared_experts) * mlp
                      + d * self.num_experts)
            elif kind == "rec":
                r = self.d_rnn or d
                n += 2 * d * r + r * d + 2 * r * r + 4 * r + mlp
            elif kind == "ssm":
                din = self.ssm_expand * d
                heads = din // self.ssm_head_dim
                n += d * (2 * din + 2 * self.ssm_state + heads) + din * d
            else:
                n += mlp
        return n

    def param_count(self) -> int:
        """Every weight, all experts included."""
        return self._weights(self.num_experts)

    def active_param_count(self) -> int:
        """The weights one token uses: top-k routed experts per MoE block."""
        return self._weights(self.top_k)

    def layer_kind(self, i: int) -> str:
        """Block kind of layer i: MoE models lead with
        ``first_dense_layers`` dense-FFN layers; a VLM makes every
        ``cross_attn_every``-th layer ``cross``; a hybrid tiles
        ``block_pattern``."""
        if self.family == "ssm":
            return "ssm"
        if self.family == "moe":
            return "attn" if i < self.first_dense_layers else "moe"
        if self.family == "vlm" and self.cross_attn_every:
            return "cross" if (i + 1) % self.cross_attn_every == 0 else "attn"
        if self.family == "hybrid":
            return self.block_pattern[i % len(self.block_pattern)]
        return "attn"

    @property
    def pattern(self) -> Tuple[str, ...]:
        """Block kinds of one scanned layer group."""
        if self.family == "ssm":
            return ("ssm",)
        if self.family == "moe":
            return ("moe",)
        if self.family == "vlm" and self.cross_attn_every:
            return ("attn",) * (self.cross_attn_every - 1) + ("cross",)
        if self.family == "hybrid":
            return self.block_pattern
        return ("attn",)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input shape of the dry-run's cells (``launch/programs.py``)."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
