"""falcon-mamba-7b [arXiv:2410.05355; unverified] — attention-free Mamba-1
SSM: 64 blocks of a norm and a mixer (no FFN half), d_inner 8192, state 16,
conv width 4, dt_rank 256, an untied lm-head."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab_size=65024,
    rope="none",
    ssm_state=16, ssm_expand=2, ssm_conv=4, ssm_dt_rank=256,
    norm="rmsnorm",
    source="arXiv:2410.05355; unverified",
))
