"""Model configuration (counterpart of ``repro/configs/base.py``).

What the port's decoder families need: the dense transformer (granite), the
mixture-of-experts family (deepseek-moe, llama4-scout) and the audio decoder
(musicgen, whose frame embeddings come in as input: ``embed_inputs``), whose
``models/lm.py`` blocks are ported. Hybrid, SSM and VLM fields come with the
slices that port those blocks.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | audio (ported yet)
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

    window: int = 0                  # local attention window (0 = global)
    # Modality frontend: False => the inputs are precomputed embeddings
    # (``frame_embeddings``, musicgen) and the model has no token table.
    embed_inputs: bool = True
    sigma_init: float = 1e-4

    @property
    def attn_dim(self) -> int:
        return self.num_heads * self.head_dim

    def _weights(self, experts: int) -> int:
        """Weights (means only) with ``experts`` routed experts counted per
        MoE block: embedding (where the model embeds tokens), blocks
        (attention, MLP or router, routed and shared experts), lm head."""
        d, kv = self.d_model, self.num_kv_heads * self.head_dim
        mlp = (3 if self.gated_mlp else 2) * d * self.d_ff
        n = (2 if self.embed_inputs else 1) * self.vocab_size * d
        for i in range(self.num_layers):
            n += 2 * d * self.attn_dim + 2 * d * kv
            if self.layer_kind(i) == "moe":
                n += ((experts + self.num_shared_experts) * mlp
                      + d * self.num_experts)
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
        ``first_dense_layers`` dense-FFN layers."""
        if self.family == "moe":
            return "attn" if i < self.first_dense_layers else "moe"
        return "attn"

    @property
    def pattern(self) -> Tuple[str, ...]:
        """Block kinds of one scanned layer group."""
        return ("moe",) if self.family == "moe" else ("attn",)
