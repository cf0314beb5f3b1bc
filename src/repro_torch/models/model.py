"""Model facade for the dense family on the paged serving layout:

  * ``init(seed, device, bits=..., pack=..., policy=...)`` -> params
    (random weights from a ``torch.Generator``; with a width given, each
    leaf is quantized as soon as it is drawn, so peak memory stays near the
    codes plus one float leaf)
  * ``quantize(params, bits, pack, policy)`` -> PSI serving params
  * ``prefill(params, tokens, ...)``         -> (last logits, dense cache)
  * ``decode_step(params, batch, cache)``     -> (logits, cache updated in
                                                place)
  * ``decode_scan(params, batch, cache, M)``  -> ((M, B) tokens, carry,
                                                cache): M steps with EOS
                                                and budget retirement
  * ``init_cache`` / ``insert_cache``         -> the paged pool
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.core import quantizer
from repro_torch.models import attention, kvcache as kvc, layers, transformer
from repro_torch.models.kvcache import KVCache
from repro_torch.quant import embed, linear, tied_logits

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _positions(B, S, device, offset=0):
    return torch.arange(offset, offset + S, dtype=torch.int32,
                        device=device)[None].expand(B, S)


class Model:
    def __init__(self, cfg):
        if cfg.family != "dense":
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported yet (dense only)")
        self.cfg = cfg

    @property
    def dtype(self) -> torch.dtype:
        return _DTYPES[self.cfg.dtype]

    # ------------------------------------------------------------------ init
    def param_specs(self):
        """(path, shape, std) per leaf, in draw order; std None = ones."""
        cfg = self.cfg
        d, hd = cfg.d_model, cfg.resolved_head_dim
        hq, hkv, ff, V = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, cfg.vocab_size
        specs = [("embed", (V, d), d ** -0.5)]
        for i in range(cfg.n_layers):
            pre = f"layers/{i}"
            specs += [
                (f"{pre}/norm1/scale", (d,), None),
                (f"{pre}/attn/wq", (d, hq * hd), d ** -0.5),
                (f"{pre}/attn/wk", (d, hkv * hd), d ** -0.5),
                (f"{pre}/attn/wv", (d, hkv * hd), d ** -0.5),
                (f"{pre}/attn/wo", (hq * hd, d), (hq * hd) ** -0.5),
            ]
            if cfg.qk_norm:
                specs += [(f"{pre}/attn/q_norm_scale", (hd,), None),
                          (f"{pre}/attn/k_norm_scale", (hd,), None)]
            specs += [
                (f"{pre}/norm2/scale", (d,), None),
                (f"{pre}/mlp/w_gate", (d, ff), d ** -0.5),
                (f"{pre}/mlp/w_up", (d, ff), d ** -0.5),
                (f"{pre}/mlp/w_down", (ff, d), ff ** -0.5),
            ]
        specs.append(("norm_f/scale", (d,), None))
        if not cfg.tie_embeddings:
            specs.append(("lm_head", (d, V), d ** -0.5))
        return specs

    def init(self, seed: int = 0, device=None, bits: Optional[int] = None,
             pack: bool = False, policy=None) -> dict:
        """Random params from a seeded ``torch.Generator`` on ``device``
        (CUDA unless the caller names another); with ``bits``/``policy``,
        each quantizable leaf is quantized right after it is drawn."""
        device = resolve_device(device)
        policy = quantizer.parse_policy(policy)
        quant = bits is not None or bool(policy)
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
        params = {"layers": [{} for _ in range(self.cfg.n_layers)]}
        for path, shape, std in self.param_specs():
            if std is None:
                leaf = torch.ones(shape, dtype=torch.float32, device=device)
            else:
                leaf = torch.randn(shape, generator=gen, dtype=torch.float32,
                                   device=device) * std
            if quant and quantizer.is_quantizable(path, leaf):
                leaf = quantizer.quantize_leaf(path, leaf, bits, pack, policy)
            node = params
            keys = path.split("/")
            for k in keys[:-1]:
                node = node[int(k)] if isinstance(node, list) else \
                    node.setdefault(k, {})
            node[keys[-1]] = leaf
        return params

    def quantize(self, params, bits: Optional[int] = None, pack=False,
                 policy=None) -> dict:
        return quantizer.quantize_param_tree(params, bits, pack=pack,
                                             policy=policy)

    # --------------------------------------------------------------- forward
    def _logits(self, params, x):
        cfg = self.cfg
        if cfg.tie_embeddings:
            return tied_logits(params["embed"], x, cfg.quant_mode)
        return linear(params["lm_head"], x, cfg.quant_mode)

    def forward(self, params, tokens):
        """tokens (B, S) -> (logits (B, S, V), per-layer prefill states)."""
        B, S = tokens.shape
        x = embed(params["embed"], tokens, self.dtype)
        positions = _positions(B, S, tokens.device)
        x, states = transformer.apply_decoder_stack(params["layers"], x,
                                                    self.cfg, positions)
        x = layers.apply_norm(params["norm_f"], x, self.cfg)
        return self._logits(params, x), states

    def prefill(self, params, tokens, cache_len: Optional[int] = None,
                true_lens=None):
        """Forward the prompt; return (last-token logits (B, V), dense
        cache of extent ``cache_len`` (default S)).  ``true_lens`` (B,)
        supports right-padded prompts: logits are taken at
        ``true_lens - 1`` and cache rows past the true length read as empty
        (k_pos -1)."""
        S = tokens.shape[1]
        C = cache_len or S
        if C < S:
            raise ValueError(f"cache_len={C} < prompt length {S}: the port "
                             f"has no ring (sliding-window) cache")
        logits, states = self.forward(params, tokens)
        kv = [_state_to_cache(self.cfg, st, S, C) for st in states]
        if true_lens is None:
            return logits[:, -1], KVCache(kv)
        B = logits.shape[0]
        tl = true_lens.to(device=tokens.device, dtype=torch.int64)
        last = logits[torch.arange(B, device=tokens.device), tl - 1]
        for st in kv:
            kp = st["k_pos"]
            st["k_pos"] = torch.where((kp >= 0) & (kp < tl[:, None]), kp,
                                      torch.full_like(kp, -1))
        return last, KVCache(kv)

    # ---------------------------------------------------------------- decode
    def init_cache(self, batch: int, seq_len: int, device=None,
                   block_size: Optional[int] = None,
                   n_blocks: Optional[int] = None) -> KVCache:
        """Paged pools: ``n_blocks`` usable blocks (default
        ``batch * ceil(seq_len / block_size)``) plus ``batch`` scratch,
        on ``device`` (CUDA unless the caller names another)."""
        device = resolve_device(device)
        bs = block_size or self.cfg.cache_block_size
        nb = (n_blocks if n_blocks is not None
              else batch * kvc.blocks_for(seq_len, bs))
        pools = [attention.init_paged_kv_cache(self.cfg, nb + batch, bs,
                                               self.dtype, device)
                 for _ in range(self.cfg.n_layers)]
        return KVCache(pools, kvc.PAGED, bs, nb)

    def decode_step(self, params, batch, cache: KVCache):
        """batch: {"token": (B, 1), "pos": (B, 1) int32, "active": (B,)
        bool, "block_table": (B, n_bt) int32}.  Rows with ``active`` False
        compute a throwaway logit and write only their scratch block."""
        if not cache.paged:
            raise ValueError("decode runs against the paged cache")
        x = embed(params["embed"], batch["token"], self.dtype)
        x, _ = transformer.apply_decoder_stack_decode(
            params["layers"], x, self.cfg, batch["pos"], cache.kv,
            batch["block_table"], active=batch.get("active"))
        x = layers.apply_norm(params["norm_f"], x, self.cfg)
        return self._logits(params, x)[:, 0], cache

    def decode_scan(self, params, batch, cache: KVCache, length: int):
        """``length`` greedy decode steps with retirement on the device.

        batch: {"token": (B, 1), "pos": (B, 1) int32, "active": (B,) bool,
        "remaining": (B,) int32 emission budget per slot, "eos_id": int32
        scalar tensor (-1 disables; greedy tokens are >= 0), "block_table":
        (B, n_bt) int32}.  Each step is a masked :meth:`decode_step`, then::

            remaining -= active
            active   &= (next != eos_id) & (remaining > 0)

        ``token`` freezes at the last live emission and ``pos`` advances
        only on entry-active steps, so the carry is the state a
        step-at-a-time loop would reach; the host recovers the streams with
        ``scheduler.replay_round``.  The block table is the same for every
        step: the caller allocates every block the round can touch first.

        Returns ((length, B) raw per-step greedy tokens, carry dict with the
        token/pos/active/remaining keys, cache updated in place).
        """
        tok, p = batch["token"], batch["pos"]
        act, rem = batch["active"], batch["remaining"]
        eos, bt = batch["eos_id"], batch["block_table"]
        toks = []
        for _ in range(length):
            logits, cache = self.decode_step(
                params, {"token": tok, "pos": p, "active": act,
                         "block_table": bt}, cache)
            nxt = torch.argmax(logits, -1).to(torch.int32)
            rem = rem - act.to(torch.int32)
            new_act = act & (nxt != eos) & (rem > 0)
            tok = torch.where(act[:, None], nxt[:, None], tok)
            p = p + act[:, None].to(torch.int32)
            act = new_act
            toks.append(nxt)
        carry = {"token": tok, "pos": p, "active": act, "remaining": rem}
        return torch.stack(toks), carry, cache

    def insert_cache(self, cache: KVCache, seq_cache: KVCache, slot: int,
                     block_row) -> KVCache:
        """Scatter a batch-1 dense prefill cache into the blocks named by
        ``block_row`` (n_bt,); -1 entries go to the slot's scratch block."""
        transformer.insert_paged_stack_cache(cache.kv, seq_cache.kv,
                                             block_row,
                                             cache.n_blocks + int(slot))
        return cache


def _state_to_cache(cfg, st, S, C):
    """Prefill state (B, S, ...) -> dense cache of extent C (pad rows
    empty), int8-quantized under kv_quant="int8"."""
    def pad(a, value=0):
        if S == C:
            return a
        fill = torch.full((a.shape[0], C - S) + tuple(a.shape[2:]), value,
                          dtype=a.dtype, device=a.device)
        return torch.cat([a, fill], dim=1)

    kp = pad(torch.where(st["k_pos"] >= 0, st["k_pos"],
                         torch.full_like(st["k_pos"], -1)), -1)
    k, v = pad(st["k"]), pad(st["v"])
    if cfg.kv_quant == "int8":
        kq, ks = attention._kv_quantize(k)
        vq, vs = attention._kv_quantize(v)
        return {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs, "k_pos": kp}
    return {"k": k, "v": v, "k_pos": kp}


def build_model(cfg) -> Model:
    return Model(cfg)
