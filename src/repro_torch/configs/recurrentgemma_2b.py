"""recurrentgemma-2b: Griffin hybrid, RG-LRU blocks and local attention in
a 2:1 pattern (arXiv:2402.19427). Sub-quadratic: runs long_500k."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    num_layers=26, d_model=2560, num_heads=10, num_kv_heads=1, head_dim=256,
    d_ff=7680, vocab_size=256000, activation="gelu", gated_mlp=True,
    norm="rmsnorm", positional="rope",
    block_pattern=("rec", "rec", "attn"), window=2048, d_rnn=2560,
    sub_quadratic=True,
)
