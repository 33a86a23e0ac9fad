"""zamba2-7b [hybrid] — Mamba2 backbone + shared attention block.
[arXiv:2411.15242; unverified]

81 layers = 13 groups of (5 Mamba2 + 1 application of the SHARED attn+FFN
block) + 3 trailing Mamba2 layers. The attention block's parameters are
shared across all 13 applications (Zamba2's shared-block design).
"""
from repro_torch.configs.base import (HybridConfig, ModelConfig, SSMConfig,
                                      register)


def full_config() -> ModelConfig:
    return ModelConfig(
        arch="zamba2-7b", family="hybrid",
        num_layers=81, d_model=3584, num_heads=32, num_kv_heads=32,
        d_ff=14336, vocab_size=32000, head_dim=112,
        ssm=SSMConfig(d_state=64, head_dim=64, expand=2, conv_kernel=4,
                      n_groups=1, chunk_size=256),
        hybrid=HybridConfig(ssm_per_group=5, num_groups=13, tail_ssm_layers=3),
        rope_theta=10000.0, norm_eps=1e-5,
        source="[arXiv:2411.15242; unverified]",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch="zamba2-7b", family="hybrid",
        num_layers=7, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=256, head_dim=16,
        ssm=SSMConfig(d_state=16, head_dim=16, expand=2, conv_kernel=4,
                      n_groups=1, chunk_size=32),
        hybrid=HybridConfig(ssm_per_group=2, num_groups=2, tail_ssm_layers=1),
    )


register("zamba2-7b", full_config, smoke_config)
