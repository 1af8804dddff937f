"""Config registry (counterpart of ``repro/configs/__init__.py``), for the
architectures the port runs."""
import dataclasses
import importlib

from repro_torch.configs.base import ModelConfig

_MODULES = {
    "granite-8b": "granite_8b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "musicgen-medium": "musicgen_medium",
}


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"{name!r} is not ported; ported: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}").CONFIG


def reduced_config(name: str) -> ModelConfig:
    """The same tiny same-family config as the reference's
    ``reduced_config``: d_model 64, 4 heads of 16, at most 2 KV heads (4 for
    an MHA model, which stays MHA), d_ff 128, vocab 97, at most 8 experts
    and top-2, one layer per pattern entry times two."""
    cfg = get_config(name)
    updates = dict(
        num_layers=min(cfg.num_layers, 2 * len(cfg.pattern)),
        d_model=64, d_ff=128, vocab_size=97,
        num_heads=4 if cfg.num_heads else 0,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads else 0,
        head_dim=16 if cfg.head_dim else 0,
        num_experts=min(cfg.num_experts, 8) if cfg.num_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        window=8 if cfg.window else 0,
    )
    if cfg.num_kv_heads and cfg.num_kv_heads == cfg.num_heads:
        updates["num_kv_heads"] = 4
    return dataclasses.replace(cfg, **updates)


__all__ = ["ModelConfig", "get_config", "reduced_config"]
