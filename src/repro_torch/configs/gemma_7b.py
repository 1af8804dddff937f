"""gemma-7b: GeGLU, head_dim 256, 256k vocab [arXiv:2403.08295; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b", family="dense",
    num_layers=28, d_model=3072, num_heads=16, num_kv_heads=16, head_dim=256,
    d_ff=24576, vocab_size=256000, activation="gelu", gated_mlp=True,
    norm="rmsnorm", positional="rope",
)
