"""granite-moe-3b-a800m [moe] — 40 experts top-8, d_expert=512.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""
from repro_torch.configs.base import ModelConfig, MoEConfig, register


def full_config() -> ModelConfig:
    return ModelConfig(
        arch="granite-moe-3b-a800m", family="moe",
        num_layers=32, d_model=1536, num_heads=24, num_kv_heads=8,
        d_ff=512, vocab_size=49155, head_dim=64,
        tie_embeddings=True,
        moe=MoEConfig(num_experts=40, top_k=8, d_expert=512,
                      capacity_factor=1.25),
        rope_theta=10000.0, norm_eps=1e-5,
        source="[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch="granite-moe-3b-a800m", family="moe",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=96, vocab_size=256, head_dim=16,
        tie_embeddings=True,
        moe=MoEConfig(num_experts=8, top_k=2, d_expert=96,
                      capacity_factor=1.5),
    )


register("granite-moe-3b-a800m", full_config, smoke_config)
