from repro_torch.configs.base import (
    EncDecConfig,
    FrontendConfig,
    HybridConfig,
    ModelConfig,
    MoEConfig,
    RunConfig,
    SHAPES,
    ShapeConfig,
    SSMConfig,
    get_config,
    get_smoke_config,
    list_archs,
    register,
    replace,
)

# the reference's arch lists (``repro.configs.ASSIGNED_ARCHS`` /
# ``PAPER_MODELS``), every one registered here
ASSIGNED_ARCHS = (
    "whisper-small", "qwen3-8b", "stablelm-3b", "granite-3-2b", "qwen3-14b",
    "granite-moe-3b-a800m", "qwen2-moe-a2.7b", "llava-next-34b",
    "zamba2-7b", "mamba2-130m",
)

PAPER_MODELS = ("llama3-70b", "mistral-123b", "qwen3-235b", "llama3-405b")

__all__ = ["ASSIGNED_ARCHS", "PAPER_MODELS", "EncDecConfig", "FrontendConfig",
           "HybridConfig", "ModelConfig", "MoEConfig", "RunConfig", "SHAPES",
           "ShapeConfig", "SSMConfig",
           "get_config", "get_smoke_config", "list_archs", "register", "replace"]
