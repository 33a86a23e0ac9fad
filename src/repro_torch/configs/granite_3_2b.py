"""granite-3-2b [dense] — GQA, granite scalar multipliers.
[hf:ibm-granite/granite-3.0-2b-base; hf]"""
from repro_torch.configs.base import ModelConfig, register


def full_config() -> ModelConfig:
    return ModelConfig(
        arch="granite-3-2b", family="dense",
        num_layers=40, d_model=2048, num_heads=32, num_kv_heads=8,
        d_ff=8192, vocab_size=49155, head_dim=64,
        tie_embeddings=True,
        embedding_multiplier=12.0, logits_scaling=8.0,
        residual_multiplier=0.22, attention_multiplier=0.015625,
        rope_theta=10000.0, norm_eps=1e-5,
        source="[hf:ibm-granite/granite-3.0-2b-base; hf]",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch="granite-3-2b", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=256, head_dim=16,
        tie_embeddings=True,
        embedding_multiplier=12.0, logits_scaling=8.0,
        residual_multiplier=0.22, attention_multiplier=0.25,
    )


register("granite-3-2b", full_config, smoke_config)
