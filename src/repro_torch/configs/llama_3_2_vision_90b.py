"""llama-3.2-vision-90b: VLM backbone, a cross-attention layer to the image
embeddings every 5th layer; the vision frontend is a stub (the caller
passes the patch embeddings) [hf:meta-llama/Llama-3.2-11B-Vision;
unverified]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b", family="vlm",
    num_layers=100, d_model=8192, num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=28672, vocab_size=128256, activation="silu", gated_mlp=True,
    norm="rmsnorm", positional="rope",
    cross_attn_every=5, num_image_tokens=1024,
)
