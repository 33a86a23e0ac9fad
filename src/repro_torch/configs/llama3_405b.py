"""llama3-405b — paper evaluation workload (Fig. 6). [hf:meta-llama/Llama-3.1-405B; hf]"""
from repro_torch.configs.base import ModelConfig, register


def full_config() -> ModelConfig:
    return ModelConfig(
        arch="llama3-405b", family="dense",
        num_layers=126, d_model=16384, num_heads=128, num_kv_heads=8,
        d_ff=53248, vocab_size=128256, head_dim=128,
        rope_theta=500000.0, norm_eps=1e-5,
        source="[hf:meta-llama/Llama-3.1-405B; hf]",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch="llama3-405b", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=256, head_dim=16,
    )


register("llama3-405b", full_config, smoke_config)
