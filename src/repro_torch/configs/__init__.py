"""Architecture registry of the port: the dense, MoE, VLM and hybrid
configs (the SSM and encoder-decoder families arrive with their model
code)."""
from repro_torch.configs.base import (ModelConfig, get_config, reduced_config,
                                      register)
from repro_torch.configs import (chatglm3_6b, granite_34b,  # noqa: F401
                                 mixtral_8x22b, phi3_medium_14b,
                                 qwen2_vl_2b, qwen3_8b, qwen3_moe_30b_a3b,
                                 recurrentgemma_9b)

__all__ = ["ModelConfig", "get_config", "reduced_config", "register"]
