"""chatglm3-6b [arXiv:2406.12793; hf] — dense, 2d-RoPE (partial rotary), GQA kv=2."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="chatglm3-6b", family="dense",
    n_layers=28, d_model=4096, n_heads=32, n_kv_heads=2,
    d_ff=13696, vocab_size=65024, head_dim=128,
    rope="rope2d",            # RoPE applied to half the head dims (2d scheme)
    act="swiglu", norm="rmsnorm",
    source="arXiv:2406.12793; hf",
))
