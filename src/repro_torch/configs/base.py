"""Model configuration for the PyTorch port: the architecture record, the
registry behind ``--arch`` and the reduced (CPU test) variant.

Only the fields the six families (dense, MoE, VLM, hybrid, SSM and
encoder-decoder) and their serving paths read are kept; the field names, defaults and reduced widths are those of the
JAX package's configuration, so the same names build the same shapes in
both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense (qwen3-8b, phi3-medium-14b,
                                    # granite-34b, chatglm3-6b) | moe
                                    # (qwen3-moe-30b-a3b, mixtral-8x22b)
                                    # | vlm (qwen2-vl-2b) | hybrid
                                    # (recurrentgemma-9b) | ssm
                                    # (falcon-mamba-7b) | encdec
                                    # (whisper-base)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // n_heads

    # --- attention ---
    attn_type: str = "full"         # full | swa (sliding window: a ring
                                    # of `window` positions, dense only)
    window: int = 0                 # the swa window
    rope: str = "rope"              # rope (plain NeoX rotate-half) | rope2d
                                    # (rotate-half on the first half of the
                                    # head dims, the rest passed through) |
                                    # mrope (three position streams t, h, w
                                    # over the frequencies split 2:1:1) |
                                    # sinusoidal (added to the embeddings)
                                    # | none
    rope_theta: float = 10_000.0
    qk_norm: bool = False
    norm: str = "rmsnorm"           # rmsnorm | layernorm (with a bias)
    act: str = "swiglu"             # swiglu | geglu (gated, 3 matrices) |
                                    # gelu (w_down(gelu(w_up x)), 2 matrices)

    # --- MoE (per-expert intermediate size is d_ff) ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # --- SSM (mamba-1); ssm_conv is also the rec block's conv width ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_dt_rank: int = 0            # 0 -> d_model // 16

    # --- hybrid (recurrentgemma): a repeating block pattern ---
    block_pattern: Tuple[str, ...] = ()   # e.g. ("rec", "rec", "attn")
    d_rnn: int = 0                  # 0 -> d_model
    rglru_c: float = 8.0

    # --- encoder-decoder (whisper backbone; the conv frontend is a stub:
    # frame embeddings arrive precomputed, zeros at serving) ---
    n_enc_layers: int = 0
    enc_frames: int = 1500

    # --- VLM (qwen2-vl backbone; the vision frontend is a stub: patch
    # embeddings arrive precomputed and replace the leading tokens) ---
    vision_patches: int = 0

    # --- numerics / technique ---
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    quant_mode: str = "none"        # none | qatN (training: fake-quant
                                    # with the straight-through gradient)
                                    # | psiN (serving format label)
    dtype: str = "bfloat16"

    # --- decode cache ---
    kv_quant: str = ""              # "" | "int8"
    cache_layout: str = "auto"      # auto | dense (per-slot slabs; the
                                    # ring for swa) | paged (block pool)
    cache_block_size: int = 16      # positions per paged block
    # shared-prefix block reuse over the paged pool: admissions serve the
    # longest cached block-aligned prompt prefix out of ref-counted blocks
    # and prefill only the suffix (set per serve by --prefix-cache)
    prefix_cache: bool = False

    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def resolved_dt_rank(self) -> int:
        return self.ssm_dt_rank or max(self.d_model // 16, 1)

    @property
    def resolved_d_rnn(self) -> int:
        return self.d_rnn or self.d_model

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def paged_capable(self) -> bool:
        """True when every decode-cache leaf is full-attention KV, the only
        state a block pool can hold: recurrent and SSM state is fixed-size
        (no paging to do), an SWA ring wraps past ``max_seq``, which a
        bounded block table cannot, and whisper's decoder carries
        ``enc_out``."""
        return (self.family in ("dense", "moe", "vlm")
                and self.attn_type == "full")

    @property
    def resolved_cache_layout(self) -> str:
        """``cache_layout`` with "auto" resolved: paged where the stack can
        be paged, dense otherwise."""
        if self.cache_layout == "auto":
            return "paged" if self.paged_capable else "dense"
        if self.cache_layout not in ("dense", "paged"):
            raise ValueError(f"unknown cache_layout {self.cache_layout!r} "
                             f"(want auto | dense | paged)")
        if self.cache_layout == "paged" and not self.paged_capable:
            raise ValueError(
                f"{self.name or self.family}: cache_layout=paged requires a "
                f"pure full-attention stack (family {self.family!r}, "
                f"attn_type {self.attn_type!r} must use dense)")
        return self.cache_layout

    @property
    def prefix_cache_enabled(self) -> bool:
        """``prefix_cache`` validated: block reuse shares paged pool blocks
        (a dense slab has none to share) and replays absolute RoPE
        positions from a scalar ``pos0``."""
        if not self.prefix_cache:
            return False
        if self.resolved_cache_layout != "paged":
            raise ValueError(
                f"{self.name or self.family}: prefix_cache requires the "
                f"paged cache layout (resolved "
                f"{self.resolved_cache_layout!r})")
        if self.rope != "rope":
            raise ValueError(
                f"{self.name or self.family}: prefix_cache requires plain "
                f"RoPE positions, got rope={self.rope!r}")
        return True

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k: bounded decode state (SSM / hybrid / SWA)."""
        return (self.family in ("ssm", "hybrid")
                or (self.attn_type == "swa" and self.window > 0))

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head), the JAX
        package's formula term for term."""
        d, L = self.d_model, self.n_layers
        hd = self.resolved_head_dim
        q = self.n_heads * hd
        kv = self.n_kv_heads * hd
        n = self.vocab_size * d                       # embed
        if not self.tie_embeddings:
            n += d * self.vocab_size                  # lm head

        def attn_params():
            return d * q + 2 * d * kv + q * d

        def mlp_params(ff):
            if self.act in ("swiglu", "geglu"):
                return 3 * d * ff
            return 2 * d * ff
        if self.family == "ssm":
            di, r, s = self.d_inner, self.resolved_dt_rank, self.ssm_state
            per = (d * 2 * di + di * self.ssm_conv + di * (r + 2 * s)
                   + r * di + di * s + di + di * d)
            n += L * per
        elif self.family == "hybrid":
            pat = self.block_pattern or ("rec",)
            dr = self.resolved_d_rnn
            rec = 2 * d * dr + dr * self.ssm_conv + 2 * dr * dr + dr * d
            for i in range(L):
                kind = pat[i % len(pat)]
                n += ((attn_params() if kind == "attn" else rec)
                      + mlp_params(self.d_ff))
        elif self.family == "moe":
            per = attn_params() + d * self.n_experts  # router
            per += self.n_experts * 3 * d * self.d_ff
            n += L * per
        elif self.family == "encdec":
            enc = self.n_enc_layers * (attn_params() + mlp_params(self.d_ff))
            dec = L * (2 * attn_params() + mlp_params(self.d_ff))
            n += enc + dec
        else:                                          # dense / vlm
            n += L * (attn_params() + mlp_params(self.d_ff))
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k of n_experts)."""
        if self.family != "moe":
            return self.param_count()
        full = self.param_count()
        expert = self.n_layers * self.n_experts * 3 * self.d_model * self.d_ff
        active = expert * self.top_k / self.n_experts
        return int(full - expert + active)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input shape of the analytic roofline's cells."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether a (config, shape) cell is meaningful, and why not."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("pure full-attention arch: 524k dense-KV decode is the "
                       "quadratic regime long_500k excludes")
    return True, ""


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


def list_configs():
    """The registered config names, sorted."""
    import repro_torch.configs  # noqa: F401  (populates the registry)
    return sorted(_REGISTRY)


def reduced_config(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Tiny same-family config for CPU tests: the JAX package's reduced
    widths (float32, 2 layers or one block pattern, d_model 64, 4 q heads,
    <= 2 kv heads, head_dim 16, d_ff 128, vocab 256, a window of at most
    32, d_rnn 64 for the hybrid, at most 8 vision patches, an SSM state
    of at most 8 and dt_rank 8, 2 encoder layers over 16 frames; for MoE
    at most 8 experts, top-2, and a capacity factor of at least 8, so that
    no token drops unless the caller passes a lower one)."""
    moe = bool(cfg.n_experts)
    small = dict(
        dtype="float32",
        capacity_factor=(max(cfg.capacity_factor, 8.0) if moe
                         else cfg.capacity_factor),
        n_experts=min(cfg.n_experts, 8) if moe else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        n_layers=max(2, len(cfg.block_pattern)),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 0,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        window=min(cfg.window, 32) if cfg.window else 0,
        vision_patches=(min(cfg.vision_patches, 8) if cfg.vision_patches
                        else 0),
        d_rnn=64 if cfg.family == "hybrid" else 0,
        ssm_state=min(cfg.ssm_state, 8) if cfg.ssm_state else 0,
        ssm_dt_rank=8 if cfg.family == "ssm" else 0,
        n_enc_layers=2 if cfg.n_enc_layers else 0,
        enc_frames=16 if cfg.n_enc_layers else 1500,
    )
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
