"""llama3-70b — paper evaluation workload (Fig. 6). [hf:meta-llama/Meta-Llama-3-70B; hf]"""
from repro_torch.configs.base import ModelConfig, register


def full_config() -> ModelConfig:
    return ModelConfig(
        arch="llama3-70b", family="dense",
        num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
        d_ff=28672, vocab_size=128256, head_dim=128,
        rope_theta=500000.0, norm_eps=1e-5,
        source="[hf:meta-llama/Meta-Llama-3-70B; hf]",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch="llama3-70b", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=256, head_dim=16,
    )


register("llama3-70b", full_config, smoke_config)
