"""The paper's MLP (784-100-100-10) — Tables 1/2/4/5, Figs 5-7."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="paper-mlp", family="mlp",
    num_layers=3, d_model=100, vocab_size=10,
)
