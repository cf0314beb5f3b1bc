"""qwen2-vl-2b [arXiv:2409.12191; hf] — VLM backbone with M-RoPE, tied
embeddings.

The vision frontend is a stub: precomputed patch embeddings (B,
vision_patches, d_model) replace the leading token embeddings, and M-RoPE
position streams (B, 3, S) for the temporal / height / width sections come
with the inputs.  Serving passes neither: three equal streams, no splice.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2-vl-2b", family="vlm",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2,
    d_ff=8960, vocab_size=151936, head_dim=128,
    rope="mrope", rope_theta=1e6,
    vision_patches=256,
    act="swiglu", norm="rmsnorm",
    tie_embeddings=True,
    source="arXiv:2409.12191; hf",
))
