"""musicgen-medium: decoder-only over EnCodec tokens; the EnCodec frontend
is a stub, so the inputs are frame embeddings [arXiv:2306.05284; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium", family="audio",
    num_layers=48, d_model=1536, num_heads=24, num_kv_heads=24, head_dim=64,
    d_ff=6144, vocab_size=2048, activation="gelu", gated_mlp=False,
    norm="layernorm", positional="sinusoidal",
    embed_inputs=False,
)
