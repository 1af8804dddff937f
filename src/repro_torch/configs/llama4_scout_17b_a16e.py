"""llama4-scout-17b-a16e: MoE with 16 routed experts, top-1, plus one shared
expert, as in the Hugging Face reference architecture
(meta-llama/Llama-4-Scout-17B-16E)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e", family="moe",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=202048, activation="silu", gated_mlp=True,
    norm="rmsnorm", positional="rope",
    num_experts=16, top_k=1, num_shared_experts=1,
)
