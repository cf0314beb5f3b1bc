"""qwen3-8b [hf:Qwen/Qwen3-8B; hf] — dense, qk-norm, GQA kv=8."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=12288, vocab_size=151936, head_dim=128,
    rope="rope", rope_theta=1e6, qk_norm=True,
    act="swiglu", norm="rmsnorm",
    source="hf:Qwen/Qwen3-8B; hf",
))
