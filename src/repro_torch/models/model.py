"""Model facade for every family — dense, MoE, VLM, the hybrid (RG-LRU),
the SSM (Mamba-1) and the encoder-decoder (whisper) — on both serving
layouts (the paged block pool and the dense per-slot slab, a ring for
SWA; recurrent state, SSM state and the encoder output always dense):

  * ``init(seed, device, bits=..., pack=..., policy=...,
    qat_precondition=...)`` -> params (random weights from a
    ``torch.Generator``; with a width given, each leaf is quantized as soon
    as it is drawn, so peak memory stays near the codes plus one float
    leaf)
  * ``quantize(params, bits, pack, policy)`` -> PSI serving params
  * ``loss(params, batch)``                  -> (loss, {"ce", "aux"}):
                                                next-token cross-entropy
                                                plus the MoE auxiliary
                                                loss, differentiable
                                                (training; ``qatN``
                                                fake-quantizes weights)
  * ``prefill(params, tokens, ...)``         -> (last logits, dense cache);
                                                with ``pos0``/``ctx_kv``
                                                a suffix prefill over
                                                context KV from the pool;
                                                with ``row_lens`` a burst;
                                                with ``vision_embeds`` /
                                                ``positions`` the VLM's
                                                patch splice and M-RoPE
                                                streams; with ``frames``
                                                whisper's encoder input
  * ``gather_prefix_ctx(cache, ctx_ids)``     -> that context KV
  * ``decode_step(params, batch, cache)``     -> (logits, cache updated in
                                                place)
  * ``decode_scan(params, batch, cache, M)``  -> ((M, B) tokens, carry,
                                                cache): M steps with EOS
                                                and budget retirement
  * ``verify_step(params, batch, cache)``     -> ((B, k, V) logits, cache):
                                                the speculative verify of
                                                k tokens per slot
  * ``init_cache`` / ``insert_cache`` / ``slice_cache``
                                             -> the paged pool or the
                                                dense slab
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.core import psi, quantizer
from repro_torch.models import (attention, kvcache as kvc, layers, moe,
                                rglru, ssm, transformer)
from repro_torch.models.kvcache import KVCache
from repro_torch.quant import embed, linear, tied_head, tied_logits

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _positions(B, S, device, offset=0):
    return torch.arange(offset, offset + S, dtype=torch.int32,
                        device=device)[None].expand(B, S)


class Model:
    def __init__(self, cfg):
        if cfg.family not in ("dense", "moe", "vlm", "hybrid", "ssm",
                              "encdec"):
            raise NotImplementedError(f"family {cfg.family!r} is not ported")
        self.cfg = cfg

    @property
    def dtype(self) -> torch.dtype:
        return _DTYPES[self.cfg.dtype]

    # ------------------------------------------------------------------ init
    def param_specs(self):
        """(path, shape, init) per leaf, in draw order: a float init is a
        normal draw times that std, None ones, ``("fill", v)`` the
        constant v; the mamba block's own inits are in
        :func:`ssm.param_specs`."""
        cfg = self.cfg
        d, hd = cfg.d_model, cfg.resolved_head_dim
        hq, hkv, ff, V = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, cfg.vocab_size

        def norm(pre):
            out = [(f"{pre}/scale", (d,), None)]
            if cfg.norm == "layernorm":
                out.append((f"{pre}/bias", (d,), ("fill", 0.0)))
            return out

        def attn(pre, cross=False):
            out = [(f"{pre}/wq", (d, hq * hd), d ** -0.5),
                   (f"{pre}/wk", (d, hkv * hd), d ** -0.5),
                   (f"{pre}/wv", (d, hkv * hd), d ** -0.5),
                   (f"{pre}/wo", (hq * hd, d), (hq * hd) ** -0.5)]
            if cfg.qk_norm and not cross:
                out += [(f"{pre}/q_norm_scale", (hd,), None),
                        (f"{pre}/k_norm_scale", (hd,), None)]
            return out

        def mlp(pre):
            out = []
            if cfg.act != "gelu":                     # gated: 3 matrices
                out.append((f"{pre}/w_gate", (d, ff), d ** -0.5))
            return out + [(f"{pre}/w_up", (d, ff), d ** -0.5),
                          (f"{pre}/w_down", (ff, d), ff ** -0.5)]

        specs = [("embed", (V, d), d ** -0.5)]
        for i, kind in enumerate(transformer.layer_kinds(cfg)):
            pre = f"layers/{i}"
            specs += norm(f"{pre}/norm1")
            if kind == "mamba":                       # no FFN half
                specs += ssm.param_specs(cfg, f"{pre}/mamba")
                continue
            if kind == "rec":
                specs += rglru.param_specs(cfg, f"{pre}/rec")
            else:
                specs += attn(f"{pre}/attn")
            if kind == "xattn":
                specs += norm(f"{pre}/norm_x") + attn(f"{pre}/xattn", True)
            specs += norm(f"{pre}/norm2")
            if cfg.family == "moe":
                specs += moe.param_specs(cfg, f"{pre}/moe")
            else:
                specs += mlp(f"{pre}/mlp")
        for i in range(cfg.n_enc_layers if cfg.family == "encdec" else 0):
            pre = f"encoder/{i}"
            specs += (norm(f"{pre}/norm1") + attn(f"{pre}/attn")
                      + norm(f"{pre}/norm2") + mlp(f"{pre}/mlp"))
        specs += norm("norm_f")
        if cfg.family == "encdec":
            specs += norm("enc_norm_f")
        if not cfg.tie_embeddings:
            specs.append(("lm_head", (d, V), d ** -0.5))
        return specs

    def init(self, seed: int = 0, device=None, bits: Optional[int] = None,
             pack: bool = False, policy=None,
             qat_precondition: int = 0, share=None) -> dict:
        """Random params from a seeded ``torch.Generator`` on ``device``
        (CUDA unless the caller names another); with ``bits``/``policy``,
        each quantizable leaf is quantized right after it is drawn.

        ``qat_precondition`` N > 0 first snaps each quantizable leaf to the
        psiN grid (quantize, dequantize), as a checkpoint trained with the
        quantizer in the loop would be: random weights' logit margins
        drown in low-bit noise, so a speculative draft accepts almost
        nothing without it.

        ``share`` (a ``runtime.sharding.LeafPlacer``): a rank-local init.
        Each leaf is drawn whole, in the same order from the same
        generator, quantized, and cut to this rank's share at once
        (``share.place(path, leaf)``); the rest is freed before the next
        draw, so a rank holds its share plus one whole leaf at most.  The
        result equals the placement of the whole init bit for bit."""
        device = resolve_device(device)
        policy = quantizer.parse_policy(policy)
        quant = bits is not None or bool(policy)
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
        params = {"layers": [{} for _ in range(self.cfg.n_layers)]}
        if self.cfg.family == "encdec":
            params["encoder"] = [{} for _ in range(self.cfg.n_enc_layers)]
        for path, shape, std in self.param_specs():
            if std is None:
                leaf = torch.ones(shape, dtype=torch.float32, device=device)
            elif isinstance(std, tuple) and std[0] == "fill":
                leaf = torch.full(shape, std[1], dtype=torch.float32,
                                  device=device)
            elif isinstance(std, tuple):
                leaf = ssm.init_leaf(std, shape, gen, device)
            else:
                leaf = torch.randn(shape, generator=gen, dtype=torch.float32,
                                   device=device) * std
            if quantizer.is_quantizable(path, leaf):
                if qat_precondition:
                    leaf = quantizer.fake_quant_leaf(path, leaf,
                                                     qat_precondition)
                if quant:
                    leaf = quantizer.quantize_leaf(path, leaf, bits, pack,
                                                   policy)
            if share is not None:
                leaf = share.place(path, leaf)
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

    def serving_params(self, params) -> dict:
        """``params`` (a shallow copy) with ``tied_head``, the (D, V) codes
        of a tied PSI table transposed once (:func:`tied_head`), so the
        logits launch no transpose of the table per call; a copy of the
        codes, bit-equal to ``codes.t()``.  Params that have it, or need
        none, come back as they are."""
        if not (self.cfg.tie_embeddings
                and isinstance(params.get("embed"), psi.QuantizedTensor)
                and "tied_head" not in params):
            return params
        return dict(params, tied_head=tied_head(params["embed"]))

    # --------------------------------------------------------------- forward
    def _logits(self, params, x):
        cfg = self.cfg
        if cfg.tie_embeddings:
            return tied_logits(params["embed"], x, cfg.quant_mode,
                               head=params.get("tied_head"))
        return linear(params["lm_head"], x, cfg.quant_mode)

    def _stream_positions(self, pos):
        """(B, S) positions as the config's rope reads them: M-RoPE's three
        equal (t, h, w) streams (B, 3, S), a view on the device."""
        if self.cfg.rope == "mrope":
            return pos[:, None, :].expand(pos.shape[0], 3, pos.shape[1])
        return pos

    def _encode(self, params, frames):
        """whisper's encoder over the stub frontend's frame embeddings
        (B, F, d): plus the sinusoidal table of positions [0, F), the
        encoder stack, then ``enc_norm_f``."""
        x = frames.to(self.dtype) + layers.sinusoidal_embedding(
            frames.shape[1], self.cfg.d_model, dtype=self.dtype,
            device=frames.device)[None]
        x = transformer.apply_encoder_stack(params["encoder"], x, self.cfg)
        return layers.apply_norm(params["enc_norm_f"], x, self.cfg)

    def forward(self, params, tokens, pos0: int = 0, ctx_kv=None,
                emit_logits: bool = True, row_lens=None, positions=None,
                vision_embeds=None, frames=None, return_enc=False):
        """tokens (B, S) -> (logits (B, S, V), per-layer prefill states)
        (and the encoder output, with ``return_enc``).

        ``pos0`` / ``ctx_kv`` (suffix prefill): positions start at
        ``pos0`` and attention also reads the per-layer context KV of
        ``[0, pos0)`` (:meth:`gather_prefix_ctx`).  ``emit_logits=False``
        (a chunk that emits nothing) skips the lm-head and returns None
        logits.  ``row_lens`` (a burst): row i's attention covers its
        first ``row_lens[i]`` positions only.  ``positions``: M-RoPE's
        (B, 3, S) streams (default three equal streams from ``pos0``, as
        serving runs).  ``vision_embeds`` (B, P, d) (VLM only): the stub
        vision frontend's patch embeddings, which replace the first P
        token embeddings.  ``frames`` (B, enc_frames, d) (encoder-decoder
        only): the encoder's input, zeros (the stub frontend's serving
        input) when None; the decoder's token embeddings get the
        sinusoidal rows of their positions."""
        logits, states, enc_out, _ = self._forward(
            params, tokens, pos0, ctx_kv, emit_logits, row_lens, positions,
            vision_embeds, frames)
        return (logits, states, enc_out) if return_enc else (logits, states)

    def _forward(self, params, tokens, pos0=0, ctx_kv=None,
                 emit_logits=True, row_lens=None, positions=None,
                 vision_embeds=None, frames=None):
        """:meth:`forward`'s body: (logits, states, enc_out, aux), aux the
        stack's summed auxiliary loss."""
        B, S = tokens.shape
        cfg = self.cfg
        enc_out = None
        if cfg.family == "encdec":
            if frames is None:
                frames = torch.zeros((B, cfg.enc_frames, cfg.d_model),
                                     dtype=self.dtype, device=tokens.device)
            enc_out = self._encode(params, frames)
        elif frames is not None:
            raise ValueError(f"frames are for the encdec family, not "
                             f"{cfg.family!r}")
        x = embed(params["embed"], tokens, self.dtype)
        if vision_embeds is not None:
            if self.cfg.family != "vlm":
                raise ValueError(f"vision_embeds are for the vlm family, "
                                 f"not {self.cfg.family!r}")
            P = vision_embeds.shape[1]
            x = torch.cat([vision_embeds.to(self.dtype), x[:, P:]], dim=1)
        if positions is None:
            positions = self._stream_positions(
                _positions(B, S, tokens.device, offset=pos0))
        if cfg.rope == "sinusoidal":
            x = x + layers.sinusoidal_from_positions(positions, cfg.d_model,
                                                     self.dtype)
        x, states, aux = transformer.apply_decoder_stack(
            params["layers"], x, cfg, positions, ctx_kv=ctx_kv,
            row_lens=row_lens, enc_out=enc_out)
        logits = None
        if emit_logits:
            x = layers.apply_norm(params["norm_f"], x, cfg)
            logits = self._logits(params, x)
        return logits, states, enc_out, aux

    def loss(self, params, batch):
        """Next-token cross-entropy (the shift inside) plus the MoE
        auxiliary loss: returns (total, {"ce", "aux"}), f32 scalars.

        ``batch``: {"tokens": (B, S)} and the family's inputs
        ("vision_embeds", "positions", "frames"; see :meth:`forward`).
        The logsumexp subtracts the row max (no gradient through it),
        stores ``exp`` in the logits' dtype and sums it in f32; the gold
        logit is the activation-dtype logit read out in f32 (the JAX
        package's one-hot product sums it with zeros: the same value).
        The VLM's vision positions carry no target: the mean runs over
        positions ``>= vision_patches - 1`` only.  Nothing here runs under
        ``inference_mode`` or writes a tensor that needs a gradient, so
        autograd reaches every float leaf of ``params``."""
        tokens = batch["tokens"]
        logits, _, _, aux = self._forward(
            params, tokens, positions=batch.get("positions"),
            vision_embeds=batch.get("vision_embeds"),
            frames=batch.get("frames"))
        lg = logits[:, :-1]
        tg = tokens[:, 1:].long()
        m = lg.detach().amax(dim=-1, keepdim=True)
        ex = torch.exp(lg - m)
        logz = (torch.log(torch.sum(ex, dim=-1, dtype=torch.float32))
                + m[..., 0].to(torch.float32))
        gold = torch.gather(lg, -1, tg[..., None])[..., 0].to(torch.float32)
        cfg = self.cfg
        if cfg.family == "vlm" and cfg.vision_patches:
            pos = torch.arange(tg.shape[1], device=tg.device)[None]
            mask = (pos >= cfg.vision_patches - 1).to(torch.float32
                                                      ).expand(tg.shape)
        else:
            mask = torch.ones(tg.shape, dtype=torch.float32,
                              device=tg.device)
        ce = (torch.sum((logz - gold) * mask)
              / torch.clamp_min(mask.sum(), 1.0))
        return ce + aux, {"ce": ce, "aux": aux}

    def prefill(self, params, tokens, cache_len: Optional[int] = None,
                true_lens=None, pos0: int = 0, ctx_kv=None,
                emit_logits: bool = True, row_lens=None, positions=None,
                vision_embeds=None, frames=None):
        """Forward the prompt; return (last-token logits (B, V), dense
        cache of extent ``cache_len`` (default S), or ``window`` for SWA
        if that is less: a ring holding the last positions at slots
        ``pos % C``).  ``true_lens`` (B,) supports right-padded prompts:
        logits are taken at ``true_lens - 1`` and cache rows past the true
        length read as empty (k_pos -1).

        ``pos0`` / ``ctx_kv``: ``tokens`` hold only the suffix after the
        context; positions run ``[pos0, pos0 + S)``, the returned cache
        covers the suffix rows only, and ``true_lens`` stays
        suffix-relative (k_pos is absolute, so the pad mask is at
        ``true_lens + pos0``).  ``emit_logits=False`` returns None
        logits.  ``row_lens`` (a burst of right-padded prompts): each row's
        attention at its own bucketed length; ``positions`` /
        ``vision_embeds``: the VLM's inputs; ``frames``: whisper's
        encoder input (:meth:`forward`), whose output the cache carries as
        ``enc_out``.  A rec or mamba layer's state passes through as it is:
        recurrent state absorbs pad tokens, so the engine prefills the
        hybrid and the SSM at exact lengths."""
        S = tokens.shape[1]
        logits, states, enc_out = self.forward(
            params, tokens, pos0=pos0, ctx_kv=ctx_kv,
            emit_logits=emit_logits, row_lens=row_lens, positions=positions,
            vision_embeds=vision_embeds, frames=frames, return_enc=True)
        kv = [_states_to_cache(self.cfg, st, S, cache_len or S)
              for st in states]
        if true_lens is None:
            return ((logits[:, -1] if emit_logits else None),
                    KVCache(kv, enc_out=enc_out))
        B = tokens.shape[0]
        tl = true_lens.to(device=tokens.device, dtype=torch.int64)
        last = None
        if emit_logits:
            last = logits[torch.arange(B, device=tokens.device), tl - 1]
        end = tl[:, None] + pos0
        for st in kv:
            if "k_pos" not in st:                     # recurrent state
                continue
            kp = st["k_pos"]
            st["k_pos"] = torch.where((kp >= 0) & (kp < end), kp,
                                      torch.full_like(kp, -1))
        return last, KVCache(kv, enc_out=enc_out)

    def gather_prefix_ctx(self, cache: KVCache, ctx_ids):
        """Per-layer context KV of the pool blocks ``ctx_ids`` in the
        activation dtype (the ``ctx_kv`` of :meth:`prefill`)."""
        if not cache.paged:
            raise ValueError("prefix context is gathered from a paged "
                             "cache; this cache is dense")
        return transformer.gather_paged_ctx(cache.kv, ctx_ids, self.dtype)

    # ---------------------------------------------------------------- decode
    def init_cache(self, batch: int, seq_len: int, device=None,
                   block_size: Optional[int] = None,
                   n_blocks: Optional[int] = None,
                   layout: Optional[str] = None) -> KVCache:
        """The batched decode cache on ``device`` (CUDA unless the caller
        names another), in ``layout`` (default the config's resolved
        one).  Paged: pools of ``n_blocks`` usable blocks (default
        ``batch * ceil(seq_len / block_size)``) plus ``batch`` scratch.
        Dense: one ``(batch, C)`` slab per attention layer, C =
        ``seq_len`` or the SWA window, a rec layer's state {"h":
        (batch, d_rnn), "conv": (batch, cw-1, d_rnn)} f32, a mamba layer's
        {"ssm": (batch, d_inner, N), "conv": (batch, cw-1, d_inner)} f32,
        and whisper's ``enc_out`` (batch, enc_frames, d), zeros."""
        device = resolve_device(device)
        cfg = self.cfg
        layout = layout or cfg.resolved_cache_layout
        if layout == kvc.DENSE:
            def one(kind):
                if kind == "rec":
                    return rglru.init_rglru_state(cfg, batch, device)
                if kind == "mamba":
                    return ssm.init_mamba_state(cfg, batch, device)
                return attention.init_kv_cache(cfg, batch, seq_len,
                                               self.dtype, device)
            enc_out = None
            if cfg.family == "encdec":
                enc_out = torch.zeros((batch, cfg.enc_frames, cfg.d_model),
                                      dtype=self.dtype, device=device)
            return KVCache([one(k) for k in transformer.layer_kinds(cfg)],
                           enc_out=enc_out)
        bs = block_size or self.cfg.cache_block_size
        nb = (n_blocks if n_blocks is not None
              else batch * kvc.blocks_for(seq_len, bs))
        pools = [attention.init_paged_kv_cache(self.cfg, nb + batch, bs,
                                               self.dtype, device)
                 for _ in range(self.cfg.n_layers)]
        return KVCache(pools, kvc.PAGED, bs, nb)

    def decode_step(self, params, batch, cache: KVCache):
        """batch: {"token": (B, 1), "pos": (B, 1) int32, "active": (B,)
        bool, "block_table": (B, n_bt) int32 (paged only)}, and for
        M-RoPE optionally "positions" (B, 3, 1) (default three equal
        streams of ``pos``, built on the device).  Rows with ``active``
        False compute a throwaway logit and write only their scratch block
        (paged) or nothing (dense; their recurrent state stays frozen).
        The layout follows the cache.  Sinusoidal positions (whisper) are
        built on the device from ``pos``, and the cross attention reads
        ``cache.enc_out``."""
        bt = None
        if cache.paged:
            bt = batch.get("block_table")
            if bt is None:
                raise ValueError('paged decode needs batch["block_table"] '
                                 "(B, n_bt) int32, -1 = unallocated")
        x = embed(params["embed"], batch["token"], self.dtype)
        positions = batch.get("positions")
        if positions is None:
            positions = self._stream_positions(batch["pos"])
        if self.cfg.rope == "sinusoidal":
            x = x + layers.sinusoidal_from_positions(
                batch["pos"], self.cfg.d_model, self.dtype)
        x, _ = transformer.apply_decoder_stack_decode(
            params["layers"], x, self.cfg, positions, cache.kv, bt,
            active=batch.get("active"), enc_out=cache.enc_out)
        x = layers.apply_norm(params["norm_f"], x, self.cfg)
        return self._logits(params, x)[:, 0], cache

    def decode_scan(self, params, batch, cache: KVCache, length: int):
        """``length`` greedy decode steps with retirement on the device.

        batch: {"token": (B, 1), "pos": (B, 1) int32, "active": (B,) bool,
        "remaining": (B,) int32 emission budget per slot, "eos_id": int32
        scalar tensor (-1 disables; greedy tokens are >= 0), "block_table":
        (B, n_bt) int32 (paged only)}.  Each step is a masked
        :meth:`decode_step`, then::

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
        eos, bt = batch["eos_id"], batch.get("block_table")
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

    def verify_step(self, params, batch, cache: KVCache):
        """The speculative verify: k consecutive tokens per slot scored in
        one decode-shaped pass.

        batch: {"tokens": (B, k) — the round's feed token, then the first
        k-1 drafts; "pos0": (B, 1) int32 — the feed token's position;
        "active": (B,) bool; "block_table": (B, n_bt) int32}.  Returns
        (logits (B, k, V), cache updated in place): ``argmax(logits[:,
        j])`` is the target's next token after ``tokens[:, :j+1]``.  Target
        KV is written over all k positions, replacing the draft's."""
        if not cache.paged:
            raise ValueError("the speculative verify runs against the "
                             "paged cache")
        tokens = batch["tokens"]
        B, S = tokens.shape
        positions = batch["pos0"] + torch.arange(
            S, dtype=torch.int32, device=tokens.device)[None]
        x = embed(params["embed"], tokens, self.dtype)
        x, _ = transformer.apply_decoder_stack_verify(
            params["layers"], x, self.cfg, positions, cache.kv,
            batch["block_table"], active=batch.get("active"))
        x = layers.apply_norm(params["norm_f"], x, self.cfg)
        return self._logits(params, x), cache

    def slice_cache(self, cache: KVCache, row: int) -> KVCache:
        """Batch row ``row`` of a batched dense cache as a batch-1 cache
        (splits a burst's prefill output into per-slot inserts)."""
        if cache.paged:
            raise ValueError("slice_cache slices per-slot rows; a paged "
                             "cache has no slot rows to slice")
        row = int(row)
        enc = cache.enc_out
        return KVCache(transformer.slice_stack_cache(cache.kv, row),
                       enc_out=None if enc is None else enc[row:row + 1])

    def insert_cache(self, cache: KVCache, seq_cache: KVCache, slot: int,
                     block_row=None) -> KVCache:
        """Admit a batch-1 dense prefill cache, in place: dense writes the
        slot's row of every leaf; paged scatters the rows into the blocks
        named by ``block_row`` (n_bt,), -1 entries to the slot's scratch
        block."""
        if cache.paged:
            if block_row is None:
                raise ValueError("paged insert_cache needs block_row")
            transformer.insert_paged_stack_cache(cache.kv, seq_cache.kv,
                                                 block_row,
                                                 cache.n_blocks + int(slot))
            return cache
        transformer.insert_stack_cache(cache.kv, seq_cache.kv, int(slot))
        if cache.enc_out is not None:
            cache.enc_out[int(slot)] = seq_cache.enc_out[0].to(
                cache.enc_out.dtype)
        return cache


def _ring_layout(a, S, C):
    """A prefill sequence (B, S, ...) over positions [0, S) -> the ring
    (B, C, ...) holding its last min(S, C) entries at slots ``pos % C``:
    a pad (S <= C) or a roll of the tail window (S > C)."""
    if S <= C:
        if S == C:
            return a
        fill = a.new_zeros((a.shape[0], C - S) + tuple(a.shape[2:]))
        return torch.cat([a, fill], dim=1)
    return torch.roll(a[:, -C:], shifts=(S - C) % C, dims=1)


def _states_to_cache(cfg, st, S, cache_len):
    """One layer's prefill state (B, S, ...) -> its dense cache: extent
    ``cache_len``, or the window for SWA if less (the ring layout), pad
    rows empty (k_pos -1), int8-quantized under kv_quant="int8".  A rec
    layer's (or a mamba layer's) state is already its cache."""
    if "k_pos" not in st:
        return st
    C = attention.cache_extent(cfg, cache_len)
    kp = _ring_layout(torch.where(st["k_pos"] >= 0, st["k_pos"],
                                  torch.full_like(st["k_pos"], -1)), S, C)
    if S < C:                             # the pad slots read as empty
        kp[:, S:] = -1
    k, v = _ring_layout(st["k"], S, C), _ring_layout(st["v"], S, C)
    if cfg.kv_quant == "int8":
        kq, ks = attention._kv_quantize(k)
        vq, vs = attention._kv_quantize(v)
        return {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs, "k_pos": kp}
    return {"k": k, "v": v, "k_pos": kp}


def build_model(cfg) -> Model:
    return Model(cfg)
