"""recurrentgemma-9b [arXiv:2402.19427; unverified] — Griffin hybrid:
RG-LRU recurrent blocks and local attention in a (rec, rec, attn) pattern,
MQA kv=1, local window 2048, tied embeddings."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1,
    d_ff=12288, vocab_size=256000, head_dim=256,
    block_pattern=("rec", "rec", "attn"),
    d_rnn=4096, rglru_c=8.0,
    attn_type="swa", window=2048,
    rope="rope", act="geglu", norm="rmsnorm",
    tie_embeddings=True,
    source="arXiv:2402.19427; unverified",
))
