"""Model configuration (counterpart of ``repro/configs/base.py``).

Only what the dense decoder family needs: the port runs the attention
blocks of ``models/lm.py``. MoE, hybrid, SSM and VLM fields come with the
slices that port those blocks.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense (the only family ported yet)
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
    window: int = 0                  # local attention window (0 = global)
    sigma_init: float = 1e-4

    @property
    def attn_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def pattern(self) -> Tuple[str, ...]:
        """Block kinds of one layer group; the dense family has one."""
        return ("attn",)

    def param_count(self) -> int:
        """Weights of the dense family (means only): embedding, blocks,
        lm head."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        kv = self.num_kv_heads * self.head_dim
        block = (2 * d * self.attn_dim + 2 * d * kv
                 + (3 if self.gated_mlp else 2) * d * f)
        return 2 * v * d + self.num_layers * block
