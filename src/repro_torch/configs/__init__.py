"""Architecture registry of the port (other families arrive with their
model code)."""
from repro_torch.configs.base import (ModelConfig, get_config, reduced_config,
                                      register)
from repro_torch.configs import qwen3_8b  # noqa: F401

__all__ = ["ModelConfig", "get_config", "reduced_config", "register"]
