"""mamba2-370m: attention-free SSD, state-space duality (arXiv:2405.21060).
Sub-quadratic: runs long_500k."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m", family="ssm",
    num_layers=48, d_model=1024, num_heads=0, num_kv_heads=0, head_dim=0,
    d_ff=0, vocab_size=50280, activation="silu", gated_mlp=False,
    norm="rmsnorm", positional="none",
    ssm_state=128, ssm_expand=2, ssm_head_dim=64,
    sub_quadratic=True,
)
