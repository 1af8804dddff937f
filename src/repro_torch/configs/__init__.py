"""Config registry (counterpart of ``repro/configs/__init__.py``), for the
architectures the port runs."""
import dataclasses
import importlib

from repro_torch.configs.base import ModelConfig

_MODULES = {
    "granite-8b": "granite_8b",
    "yi-6b": "yi_6b",
    "gemma-7b": "gemma_7b",
    "internlm2-20b": "internlm2_20b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "llama-3.2-vision-90b": "llama_3_2_vision_90b",
    "musicgen-medium": "musicgen_medium",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "mamba2-370m": "mamba2_370m",
}


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"{name!r} is not ported; ported: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}").CONFIG


def reduced_config(name: str) -> ModelConfig:
    """The same tiny same-family config as the reference's
    ``reduced_config``: d_model 64, 4 heads of 16, at most 2 KV heads (4 for
    an MHA model, which stays MHA), d_ff 128, vocab 97, at most 8 experts
    and top-2, d_rnn 64, SSM state 16 in heads of 32 and chunks of 8, 8
    image tokens, one layer per pattern entry times two; a VLM keeps one
    super-block (``cross_attn_every`` layers), a hybrid 5 layers (one
    stacked group of its pattern and a 2-layer tail)."""
    cfg = get_config(name)
    updates = dict(
        num_layers=min(cfg.num_layers, 2 * len(cfg.pattern)),
        d_model=64, d_ff=128, vocab_size=97,
        num_heads=4 if cfg.num_heads else 0,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads else 0,
        head_dim=16 if cfg.head_dim else 0,
        num_experts=min(cfg.num_experts, 8) if cfg.num_experts else 0,
        d_rnn=64 if cfg.d_rnn else 0,
        window=8 if cfg.window else 0,
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_head_dim=32 if cfg.ssm_state else 64,
        ssm_chunk=8,
        num_image_tokens=8 if cfg.num_image_tokens else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
    )
    if cfg.family == "vlm":
        updates["num_layers"] = cfg.cross_attn_every
    if cfg.family == "hybrid":
        updates["num_layers"] = 5
    if cfg.num_kv_heads and cfg.num_kv_heads == cfg.num_heads:
        updates["num_kv_heads"] = 4
    return dataclasses.replace(cfg, **updates)


__all__ = ["ModelConfig", "get_config", "reduced_config"]
