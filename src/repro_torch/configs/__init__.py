"""Architecture registry of the port: every config of the JAX package
(dense, MoE, VLM, hybrid, SSM and encoder-decoder)."""
from repro_torch.configs.base import (SHAPES, ModelConfig, ShapeConfig,
                                      get_config, list_configs,
                                      reduced_config, register,
                                      shape_applicable)
from repro_torch.configs import (chatglm3_6b, falcon_mamba_7b,  # noqa: F401
                                 granite_34b, mixtral_8x22b, phi3_medium_14b,
                                 qwen2_vl_2b, qwen3_8b, qwen3_moe_30b_a3b,
                                 recurrentgemma_9b, whisper_base)

ASSIGNED_ARCHS = (
    "chatglm3-6b", "qwen3-8b", "granite-34b", "phi3-medium-14b",
    "whisper-base", "qwen3-moe-30b-a3b", "mixtral-8x22b",
    "recurrentgemma-9b", "qwen2-vl-2b", "falcon-mamba-7b",
)

__all__ = ["ASSIGNED_ARCHS", "SHAPES", "ModelConfig", "ShapeConfig",
           "get_config", "list_configs", "reduced_config", "register",
           "shape_applicable"]
