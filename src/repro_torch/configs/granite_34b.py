"""granite-34b [arXiv:2405.04324; hf] — dense code model, MQA kv=1, 88 layers.

MLP is 2-matrix GELU (gpt_bigcode lineage): with d_ff=24576 that yields
33.8B params — matching the model's name; a 3-matrix SwiGLU would be 47B.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="granite-34b", family="dense",
    n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1,
    d_ff=24576, vocab_size=49152, head_dim=128,
    rope="rope", act="gelu", norm="rmsnorm",
    source="arXiv:2405.04324; hf",
))
