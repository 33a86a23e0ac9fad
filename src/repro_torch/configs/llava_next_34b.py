"""llava-next-34b [vlm] — anyres tiling; vision tower stubbed to patch embeds.
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]

The transformer backbone only: the caller supplies precomputed patch
embeddings (anyres: base 576 patches + 4 tiles x 576 = 2880), which the
model splices in front of the text tokens.
"""
from repro_torch.configs.base import FrontendConfig, ModelConfig, register

NUM_PATCHES = 2880  # anyres: 5 x (336/14)^2


def full_config() -> ModelConfig:
    return ModelConfig(
        arch="llava-next-34b", family="vlm",
        num_layers=60, d_model=7168, num_heads=56, num_kv_heads=8,
        d_ff=20480, vocab_size=64000, head_dim=128,
        frontend=FrontendConfig(kind="vision_stub", num_embeds=NUM_PATCHES),
        rope_theta=5_000_000.0, norm_eps=1e-5,
        source="[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch="llava-next-34b", family="vlm",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=256, head_dim=16,
        frontend=FrontendConfig(kind="vision_stub", num_embeds=8),
    )


register("llava-next-34b", full_config, smoke_config)
