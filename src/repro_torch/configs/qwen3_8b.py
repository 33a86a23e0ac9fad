"""qwen3-8b [dense] — qk_norm, GQA. [hf:Qwen/Qwen3-8B; hf]"""
from repro_torch.configs.base import ModelConfig, register


def full_config() -> ModelConfig:
    return ModelConfig(
        arch="qwen3-8b", family="dense",
        num_layers=36, d_model=4096, num_heads=32, num_kv_heads=8,
        d_ff=12288, vocab_size=151936, head_dim=128,
        qk_norm=True, rope_theta=1_000_000.0, norm_eps=1e-6,
        source="[hf:Qwen/Qwen3-8B; hf]",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch="qwen3-8b", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=256, head_dim=16,
        qk_norm=True, rope_theta=1_000_000.0, norm_eps=1e-6,
    )


register("qwen3-8b", full_config, smoke_config)
