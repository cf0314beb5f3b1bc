"""phi3-medium-14b [arXiv:2404.14219; unverified] — dense, RoPE + SwiGLU + GQA kv=10."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="phi3-medium-14b", family="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=10,
    d_ff=17920, vocab_size=100352, head_dim=128,
    rope="rope", act="swiglu", norm="rmsnorm",
    source="arXiv:2404.14219; unverified",
))
