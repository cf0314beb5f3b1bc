"""Architecture registry of the port: the dense, paged-capable configs
(other families arrive with their model code)."""
from repro_torch.configs.base import (ModelConfig, get_config, reduced_config,
                                      register)
from repro_torch.configs import (chatglm3_6b, granite_34b,  # noqa: F401
                                 phi3_medium_14b, qwen3_8b)

__all__ = ["ModelConfig", "get_config", "reduced_config", "register"]
