"""yi-6b: dense llama-arch GQA LM [arXiv:2403.04652; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=4, head_dim=128,
    d_ff=11008, vocab_size=64000, activation="silu", gated_mlp=True,
    norm="rmsnorm", positional="rope",
)
