"""deepseek-moe-16b: fine-grained MoE, 2 shared + 64 routed experts, top-6
(arXiv:2401.06066). The first layer has a dense FFN, as in the Hugging Face
reference architecture."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="moe",
    num_layers=28, d_model=2048, num_heads=16, num_kv_heads=16, head_dim=128,
    d_ff=1408, vocab_size=102400, activation="silu", gated_mlp=True,
    norm="rmsnorm", positional="rope",
    num_experts=64, top_k=6, num_shared_experts=2, first_dense_layers=1,
)
