"""Model configuration for the PyTorch port: the architecture record, the
registry behind ``--arch`` and the reduced (CPU test) variant.

Only the fields the dense family and the paged serving path read are kept;
the field names, defaults and reduced widths are those of the JAX package's
configuration, so the same names build the same shapes in both packages.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense (the only family ported so far)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // n_heads

    # --- attention ---
    attn_type: str = "full"         # full (a block table cannot hold a ring)
    rope: str = "rope"              # rope (plain NeoX rotate-half)
    rope_theta: float = 10_000.0
    qk_norm: bool = False
    norm: str = "rmsnorm"
    act: str = "swiglu"

    # --- numerics / technique ---
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    quant_mode: str = "none"        # none | psiN (serving format label)
    dtype: str = "bfloat16"

    # --- decode cache ---
    kv_quant: str = ""              # "" | "int8"
    cache_layout: str = "auto"      # auto | paged
    cache_block_size: int = 16      # positions per paged block

    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def paged_capable(self) -> bool:
        return self.family == "dense" and self.attn_type == "full"

    @property
    def resolved_cache_layout(self) -> str:
        """The port serves the paged layout only; anything else is refused
        here rather than served through a path that does not exist."""
        if self.cache_layout not in ("auto", "paged"):
            raise ValueError(f"cache_layout {self.cache_layout!r}: the port "
                             f"serves the paged layout only")
        if not self.paged_capable:
            raise ValueError(f"{self.name or self.family}: the port serves "
                             f"dense full-attention stacks only")
        return "paged"


_REGISTRY = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str, **overrides) -> ModelConfig:
    import repro_torch.configs  # noqa: F401  (populates the registry)
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    cfg = _REGISTRY[name]
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def reduced_config(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Tiny same-family config for CPU tests: the JAX package's reduced
    widths (float32, 2 layers, d_model 64, 4 q heads, <= 2 kv heads,
    head_dim 16, d_ff 128, vocab 256)."""
    small = dict(
        dtype="float32",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 0,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
    )
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
