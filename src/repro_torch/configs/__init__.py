"""Architecture registry of the port: every config of the JAX package
(dense, MoE, VLM, hybrid, SSM and encoder-decoder)."""
from repro_torch.configs.base import (ModelConfig, get_config, reduced_config,
                                      register)
from repro_torch.configs import (chatglm3_6b, falcon_mamba_7b,  # noqa: F401
                                 granite_34b, mixtral_8x22b, phi3_medium_14b,
                                 qwen2_vl_2b, qwen3_8b, qwen3_moe_30b_a3b,
                                 recurrentgemma_9b, whisper_base)

__all__ = ["ModelConfig", "get_config", "reduced_config", "register"]
