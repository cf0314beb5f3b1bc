"""mixtral-8x22b [arXiv:2401.04088; hf] — MoE 8 experts top-2, sliding-window attention."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384,               # per-expert intermediate size
    vocab_size=32768, head_dim=128,
    rope="rope", rope_theta=1e6,
    attn_type="swa", window=4096,     # a ring of 4096 positions: dense only
    n_experts=8, top_k=2, capacity_factor=1.25,
    act="swiglu", norm="rmsnorm",
    source="arXiv:2401.04088; hf",
))
