"""qwen3-235b (Qwen3-235B-A22B, MoE) — paper evaluation workload (Fig. 6).
[hf:Qwen/Qwen3-235B-A22B; hf]"""
from repro_torch.configs.base import ModelConfig, MoEConfig, register


def full_config() -> ModelConfig:
    return ModelConfig(
        arch="qwen3-235b", family="moe",
        num_layers=94, d_model=4096, num_heads=64, num_kv_heads=4,
        d_ff=12288, vocab_size=151936, head_dim=128,
        qk_norm=True,
        moe=MoEConfig(num_experts=128, top_k=8, d_expert=1536,
                      capacity_factor=1.25),
        rope_theta=1_000_000.0, norm_eps=1e-6,
        source="[hf:Qwen/Qwen3-235B-A22B; hf]",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch="qwen3-235b", family="moe",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=96, vocab_size=256, head_dim=16, qk_norm=True,
        moe=MoEConfig(num_experts=8, top_k=2, d_expert=96,
                      capacity_factor=1.5),
    )


register("qwen3-235b", full_config, smoke_config)
