"""whisper-base [arXiv:2212.04356; unverified] — encoder-decoder audio
backbone: 6 encoder and 6 decoder layers, MHA 8 heads, GELU, LayerNorm,
sinusoidal positions, tied embeddings.  The conv frontend is a stub: frame
embeddings (B, enc_frames, d_model) arrive precomputed."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-base", family="encdec",
    n_layers=6, n_enc_layers=6, enc_frames=1500,
    d_model=512, n_heads=8, n_kv_heads=8,
    d_ff=2048, vocab_size=51865, head_dim=64,
    rope="sinusoidal", act="gelu", norm="layernorm",
    tie_embeddings=True,
    source="arXiv:2212.04356; unverified",
))
