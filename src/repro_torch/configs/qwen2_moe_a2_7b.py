"""qwen2-moe-a2.7b [moe] — 4 shared + 60 routed top-4, d_expert=1408.
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]"""
from repro_torch.configs.base import ModelConfig, MoEConfig, register


def full_config() -> ModelConfig:
    return ModelConfig(
        arch="qwen2-moe-a2.7b", family="moe",
        num_layers=24, d_model=2048, num_heads=16, num_kv_heads=16,
        d_ff=1408, vocab_size=151936, head_dim=128,
        moe=MoEConfig(num_experts=60, top_k=4, num_shared_experts=4,
                      d_expert=1408, capacity_factor=1.25),
        rope_theta=1_000_000.0, norm_eps=1e-6,
        source="[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch="qwen2-moe-a2.7b", family="moe",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=96, vocab_size=256, head_dim=16,
        moe=MoEConfig(num_experts=6, top_k=2, num_shared_experts=2,
                      d_expert=96, capacity_factor=1.5),
    )


register("qwen2-moe-a2.7b", full_config, smoke_config)
