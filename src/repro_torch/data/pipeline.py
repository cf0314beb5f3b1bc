"""Deterministic, resumable data for training.

``TokenStream`` is a pure function of (seed, step, host) and its whole
state is the step, so a checkpoint restores the exact sample stream;
``synthetic_mnist`` draws procedural digits for LeNet-5.  Both are numpy
only, with the JAX package's draws in its order, so their outputs are
bit-equal to the JAX package's.  ``make_batch_for`` adds the family
inputs (the VLM's vision embeds and M-RoPE streams, the
encoder-decoder's frames) from an explicit ``torch.Generator``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class TokenStream:
    """Stateless-per-step LM token stream; state = `step` alone."""
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    host_id: int = 0
    num_hosts: int = 1
    step: int = 0

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.num_hosts == 0
        return self.global_batch // self.num_hosts

    def _batch_at(self, step: int) -> np.ndarray:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_id]))
        B, S, V = self.host_batch, self.seq_len, self.vocab_size
        # a Zipf marginal plus order-1 structure: tok[t+1] drifts from tok[t]
        base = rng.zipf(1.3, size=(B, S)).astype(np.int64) % V
        drift = rng.integers(0, 17, size=(B, S))
        toks = (base + np.cumsum(drift, axis=1)) % V
        return toks.astype(np.int32)

    def __iter__(self) -> Iterator[np.ndarray]:
        return self

    def __next__(self) -> np.ndarray:
        b = self._batch_at(self.step)
        self.step += 1
        return b

    def state_dict(self) -> Dict:
        return {"step": self.step, "seed": self.seed}

    def load_state_dict(self, st: Dict) -> None:
        self.step = int(st["step"])
        self.seed = int(st["seed"])


def make_batch_for(cfg, batch: int, seq: int,
                   gen: torch.Generator) -> Dict[str, torch.Tensor]:
    """A family-correct random batch on ``gen``'s device: "tokens"
    (batch, seq) int32, and for the VLM "vision_embeds" (batch,
    vision_patches, d) and three equal "positions" streams (batch, 3,
    seq), for the encoder-decoder "frames" (batch, enc_frames, d); the
    embeddings are normal draws times d^-0.5 in the config's dtype."""
    dev = gen.device
    dtype = _DTYPES[cfg.dtype]
    out = {"tokens": torch.randint(0, cfg.vocab_size, (batch, seq),
                                   generator=gen, device=dev,
                                   dtype=torch.int32)}

    def normal(n):
        return (torch.randn((batch, n, cfg.d_model), generator=gen,
                            device=dev, dtype=torch.float32)
                * cfg.d_model ** -0.5).to(dtype)

    if cfg.family == "vlm":
        out["vision_embeds"] = normal(cfg.vision_patches)
        out["positions"] = torch.arange(
            seq, dtype=torch.int32, device=dev)[None, None].expand(
            batch, 3, seq)
    if cfg.family == "encdec":
        out["frames"] = normal(cfg.enc_frames)
    return out


def synthetic_mnist(n: int, seed: int = 0):
    """Procedural MNIST-like digits, (n, 32, 32, 1) f32 images and (n,)
    int32 labels: each class a fixed stroke template, shifted by up to 2
    pixels and with N(0, 0.25) noise."""
    rng = np.random.default_rng(seed)
    templates = np.zeros((10, 32, 32), np.float32)
    for d in range(10):
        trng = np.random.default_rng(1000 + d)
        pts = trng.integers(4, 28, size=(14, 2))
        for (r, c) in pts:
            templates[d, r - 2:r + 3, c - 2:c + 3] += 0.5
        templates[d] = np.clip(templates[d], 0, 1)
    labels = rng.integers(0, 10, size=(n,))
    imgs = templates[labels]
    dr = rng.integers(-2, 3, size=(n,))
    dc = rng.integers(-2, 3, size=(n,))
    out = np.zeros((n, 32, 32, 1), np.float32)
    for i in range(n):
        out[i, :, :, 0] = np.roll(np.roll(imgs[i], dr[i], 0), dc[i], 1)
    out += rng.normal(0, 0.25, out.shape).astype(np.float32)
    return out, labels.astype(np.int32)
