"""mamba2-130m [ssm] — SSD (state-space duality), attention-free.
[arXiv:2405.21060; unverified]"""
from repro_torch.configs.base import ModelConfig, SSMConfig, register


def full_config() -> ModelConfig:
    return ModelConfig(
        arch="mamba2-130m", family="ssm",
        num_layers=24, d_model=768, num_heads=0, num_kv_heads=0,
        d_ff=0, vocab_size=50280,
        ssm=SSMConfig(d_state=128, head_dim=64, expand=2, conv_kernel=4,
                      n_groups=1, chunk_size=256),
        tie_embeddings=True, norm_eps=1e-5,
        source="[arXiv:2405.21060; unverified]",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch="mamba2-130m", family="ssm",
        num_layers=2, d_model=64, num_heads=0, num_kv_heads=0,
        d_ff=0, vocab_size=256,
        ssm=SSMConfig(d_state=16, head_dim=16, expand=2, conv_kernel=4,
                      n_groups=1, chunk_size=32),
        tie_embeddings=True,
    )


register("mamba2-130m", full_config, smoke_config)
