from repro_torch.configs.base import (
    ModelConfig,
    RunConfig,
    get_config,
    get_smoke_config,
    list_archs,
    register,
    replace,
)

__all__ = ["ModelConfig", "RunConfig", "get_config", "get_smoke_config",
           "list_archs", "register", "replace"]
