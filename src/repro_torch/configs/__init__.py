from repro_torch.configs.base import (
    HybridConfig,
    ModelConfig,
    MoEConfig,
    RunConfig,
    SSMConfig,
    get_config,
    get_smoke_config,
    list_archs,
    register,
    replace,
)

__all__ = ["HybridConfig", "ModelConfig", "MoEConfig", "RunConfig", "SSMConfig",
           "get_config", "get_smoke_config", "list_archs", "register",
           "replace"]
