"""qwen3-14b [dense] — qk_norm, GQA (G 5). [hf:Qwen/Qwen3-14B; hf]"""
from repro_torch.configs.base import ModelConfig, register


def full_config() -> ModelConfig:
    return ModelConfig(
        arch="qwen3-14b", family="dense",
        num_layers=40, d_model=5120, num_heads=40, num_kv_heads=8,
        d_ff=17408, vocab_size=151936, head_dim=128,
        qk_norm=True, rope_theta=1_000_000.0, norm_eps=1e-6,
        source="[hf:Qwen/Qwen3-14B; hf]",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch="qwen3-14b", family="dense",
        num_layers=2, d_model=80, num_heads=5, num_kv_heads=1,
        d_ff=160, vocab_size=256, head_dim=16,
        qk_norm=True, rope_theta=1_000_000.0, norm_eps=1e-6,
    )


register("qwen3-14b", full_config, smoke_config)
