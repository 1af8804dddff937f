"""The paper's LeNet-5 — Tables 1/3/4/5."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="paper-lenet5", family="cnn",
    num_layers=5, d_model=84, vocab_size=10,
)
