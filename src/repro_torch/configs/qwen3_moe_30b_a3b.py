"""qwen3-moe-30b-a3b [hf:Qwen/Qwen3-30B-A3B; hf] — MoE 128 experts top-8, GQA kv=4."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4,
    d_ff=768,                 # per-expert intermediate size
    vocab_size=151936, head_dim=128,
    rope="rope", rope_theta=1e6, qk_norm=True,
    n_experts=128, top_k=8, capacity_factor=1.25,
    act="swiglu", norm="rmsnorm",
    source="hf:Qwen/Qwen3-30B-A3B; hf",
))
