"""The plain reference of the benchmark's dense decoder, in float32.

Pre-norm decoder layers: RMSNorm, grouped-query attention with NeoX
rotate-half RoPE and a causal softmax, then the MLP (SwiGLU
``w_down(silu(x w_gate) * (x w_up))`` or the 2-matrix
``w_down(gelu_tanh(x w_up))``), each half added to the residual; a final
RMSNorm and the lm-head.  Every weight is the float32 value of its PSI
code (:mod:`reference.psi`, re-quantized here from the seed's float
draw, :mod:`reference.weights`); activations, attention and sums stay in
float32 with TF32 off.  No cache and no batching: each sequence runs
whole, one layer at a time over all the sequences, so a model that fills
the card runs one layer's weights at a time.

``act="fp8"`` is the control: every matmul's activation input is rounded
to float8 e4m3 with a per-row scale first (the weights stay their PSI
values), the precision step below the served bfloat16.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from . import psi, weights

# query rows a step of the attention: the live scores are
# (heads, ATTN_CHUNK, length) float32
ATTN_CHUNK = 1024
FP8_MAX = 448.0


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with a scale per row (its largest entry
    maps to the format's largest), back in float32."""
    s = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


class Reference:
    """``model``: the configuration file's ``model`` block; ``bits``: the
    served PSI width; ``seed``: the run's seed (the weights')."""

    def __init__(self, model: Dict, bits: int, seed: int, device,
                 act: str = "f32"):
        if act not in ("f32", "fp8"):
            raise ValueError(f"act {act!r}: want f32 or fp8")
        self.m, self.bits, self.seed = model, int(bits), int(seed)
        self.device = torch.device(device)
        self.rnd = round_fp8 if act == "fp8" else (lambda x: x)

    def _group(self, group: str) -> Dict[str, torch.Tensor]:
        out = {}
        for name, w in weights.draw(self.m, self.seed, group,
                                    self.device).items():
            if w.dim() == 1:                     # a norm's scale
                out[name] = w
            else:
                out[name] = psi.dequantized(w, self.bits,
                                            per_row=name == "embed")
        return out

    def _norm(self, x, scale):
        ms = torch.mean(x * x, dim=-1, keepdim=True)
        return x * torch.rsqrt(ms + self.m["norm_eps"]) * scale

    def _mm(self, x, w):
        return self.rnd(x) @ w

    def _rope(self, x):
        """x (L, H, D) at positions 0 .. L-1."""
        L, _, D = x.shape
        freqs = 1.0 / (self.m["rope_theta"] ** (
            torch.arange(0, D, 2, dtype=torch.float32, device=x.device) / D))
        ang = torch.arange(L, dtype=torch.float32, device=x.device)[:, None] \
            * freqs[None]
        cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
        h = D // 2
        x1, x2 = x[..., :h], x[..., h:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    def _attention(self, q, k, v):
        """Causal attention, q (L, Hq, D), k / v (L, Hkv, D) -> (L, Hq*D)."""
        L, hq, D = q.shape
        hkv = k.shape[1]
        g = hq // hkv                   # query head h reads KV head h // g
        qg = q.reshape(L, hkv, g, D).permute(1, 2, 0, 3)     # (hkv, g, L, D)
        kt = k.permute(1, 2, 0)[:, None]                     # (hkv, 1, D, L)
        vv = v.permute(1, 0, 2)[:, None]                     # (hkv, 1, L, D)
        out = torch.empty((hkv, g, L, D), dtype=torch.float32,
                          device=q.device)
        pos = torch.arange(L, device=q.device)
        for c0 in range(0, L, ATTN_CHUNK):
            c1 = min(L, c0 + ATTN_CHUNK)
            s = (qg[:, :, c0:c1] @ kt[..., :c1]) * (D ** -0.5)
            mask = pos[None, :c1] > pos[c0:c1, None]
            s = s.masked_fill(mask, float("-inf"))
            out[:, :, c0:c1] = torch.softmax(s, dim=-1) @ vv[:, :, :c1]
        return out.permute(2, 0, 1, 3).reshape(L, hq * D)

    def _layer(self, w, x):
        m = self.m
        L = x.shape[0]
        hd = m["head_dim"]
        h = self._norm(x, w["norm1/scale"])
        q = self._mm(h, w["attn/wq"]).view(L, m["n_heads"], hd)
        k = self._mm(h, w["attn/wk"]).view(L, m["n_kv_heads"], hd)
        v = self._mm(h, w["attn/wv"]).view(L, m["n_kv_heads"], hd)
        o = self._attention(self._rope(q), self._rope(k), v)
        x = x + self._mm(o, w["attn/wo"])
        h = self._norm(x, w["norm2/scale"])
        if m["act"] == "swiglu":
            a = F.silu(self._mm(h, w["mlp/w_gate"])) * self._mm(
                h, w["mlp/w_up"])
        else:
            a = F.gelu(self._mm(h, w["mlp/w_up"]), approximate="tanh")
        return x + self._mm(a, w["mlp/w_down"])

    @torch.inference_mode()
    def logits_at(self, seqs: Sequence[torch.Tensor],
                  rows: Sequence[Sequence[int]]) -> List[torch.Tensor]:
        """For each token sequence, float32 logits (len(rows[i]), V) at
        its positions ``rows[i]`` (the logits that predict the token after
        each such position)."""
        tf32 = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            emb = self._group("embed")["embed"]
            xs = [emb[s.to(self.device, torch.int64)] for s in seqs]
            del emb
            for i in range(self.m["n_layers"]):
                w = self._group(f"layers/{i}")
                xs = [self._layer(w, x) for x in xs]
                del w
            w = self._group("head")
            out = []
            for x, r in zip(xs, rows):
                idx = torch.as_tensor(list(r), dtype=torch.int64,
                                      device=self.device)
                h = self._norm(x[idx], w["norm_f/scale"])
                out.append(self._mm(h, w["lm_head"]))
            return out
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = tf32

