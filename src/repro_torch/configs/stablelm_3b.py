"""stablelm-3b [dense] — MHA (kv=32). [hf:stabilityai/stablelm-2-1_6b; unverified]"""
from repro_torch.configs.base import ModelConfig, register


def full_config() -> ModelConfig:
    return ModelConfig(
        arch="stablelm-3b", family="dense",
        num_layers=32, d_model=2560, num_heads=32, num_kv_heads=32,
        d_ff=6912, vocab_size=50304, head_dim=80,
        rope_theta=10000.0, norm_eps=1e-5,
        source="[hf:stabilityai/stablelm-2-1_6b; unverified]",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch="stablelm-3b", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=256, head_dim=16,
    )


register("stablelm-3b", full_config, smoke_config)
