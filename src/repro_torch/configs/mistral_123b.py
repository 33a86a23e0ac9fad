"""mistral-123b (Mistral-Large-2407) — paper evaluation workload (Fig. 6).
[hf:mistralai/Mistral-Large-Instruct-2407; hf]"""
from repro_torch.configs.base import ModelConfig, register


def full_config() -> ModelConfig:
    return ModelConfig(
        arch="mistral-123b", family="dense",
        num_layers=88, d_model=12288, num_heads=96, num_kv_heads=8,
        d_ff=28672, vocab_size=32768, head_dim=128,
        rope_theta=1_000_000.0, norm_eps=1e-5,
        source="[hf:mistralai/Mistral-Large-Instruct-2407; hf]",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch="mistral-123b", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=256, head_dim=16,
    )


register("mistral-123b", full_config, smoke_config)
