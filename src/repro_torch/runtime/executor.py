"""Single-device execution for the serving engine: params and the paged
cache on one device, and the serving entry points — prefill, fused
prefill + insert and the decode step.

PyTorch runs eagerly, so there is no compile step to count; the cache is
updated in place where the JAX package donated it.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import psi
from repro_torch.models import build_model, kvcache as kvc


def params_to(tree, device):
    """A copy of a param tree with every tensor leaf on ``device``."""
    if isinstance(tree, dict):
        return {k: params_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [params_to(v, device) for v in tree]
    if isinstance(tree, (torch.Tensor, psi.QuantizedTensor)):
        return tree.to(device)
    return tree


class DeviceBlockTable:
    """Host-mirrored, device-resident block table.  The host
    ``(max_batch, n_bt)`` int32 mirror is authoritative and written like an
    ndarray; :meth:`device` refreshes the device copy one dirty row at a
    time (a full upload only when most rows changed)."""

    def __init__(self, max_batch: int, n_bt: int, device):
        self.host = np.full((max_batch, n_bt), -1, np.int32)
        self._device = None
        self._dirty = set()
        self._dev = device
        self.stats = {"reuses": 0, "row_updates": 0, "full_uploads": 0}

    def __getitem__(self, idx):
        return self.host[idx]

    def __setitem__(self, idx, val):
        self.host[idx] = val
        slot = idx[0] if isinstance(idx, tuple) else idx
        for s in np.atleast_1d(np.asarray(slot)).reshape(-1):
            self._dirty.add(int(s))

    def device(self) -> torch.Tensor:
        if self._device is None or 2 * len(self._dirty) >= self.host.shape[0]:
            self._device = torch.from_numpy(self.host.copy()).to(self._dev)
            self.stats["full_uploads"] += 1
        elif self._dirty:
            for s in sorted(self._dirty):
                self._device[s].copy_(torch.from_numpy(self.host[s].copy()))
            self.stats["row_updates"] += len(self._dirty)
        else:
            self.stats["reuses"] += 1
        self._dirty.clear()
        return self._device


class Executor:
    """Owns the device, the params on it and the serving entry points."""

    def __init__(self, cfg, params, *, max_batch: int, max_seq: int,
                 device=None, n_blocks: int = None):
        self.model = build_model(cfg)
        self.device = resolve_device(device)
        self.max_batch = max_batch
        self.max_seq = max_seq
        cfg.resolved_cache_layout                 # paged dense stacks only
        self.block_size = cfg.cache_block_size
        self.n_bt = kvc.table_width(max_seq, self.block_size)
        self.n_blocks = (n_blocks if n_blocks is not None
                         else max_batch * self.n_bt)
        self.params = params_to(params, self.device)
        self.prefill_calls = 0          # model forwards over a prompt batch

    def _t(self, a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(self.device)

    def init_cache(self) -> kvc.KVCache:
        return self.model.init_cache(self.max_batch, self.max_seq,
                                     device=self.device,
                                     block_size=self.block_size,
                                     n_blocks=self.n_blocks)

    def make_block_table(self) -> DeviceBlockTable:
        return DeviceBlockTable(self.max_batch, self.n_bt, self.device)

    def _table(self, block_table) -> torch.Tensor:
        if isinstance(block_table, DeviceBlockTable):
            return block_table.device()
        return self._t(block_table, torch.int32)

    @torch.inference_mode()
    def prefill(self, tokens, true_lens):
        """(B, Sb) right-padded prompts -> (first greedy token (B,) int32
        tensor, dense per-sequence cache at the bucketed extent).  Counts
        one model forward."""
        self.prefill_calls += 1
        logits, cache = self.model.prefill(
            self.params, self._t(tokens, torch.int32),
            true_lens=self._t(true_lens, torch.int64))
        return torch.argmax(logits, -1).to(torch.int32), cache

    @torch.inference_mode()
    def prefill_insert(self, tokens, true_lens, cache, slot: int, block_row):
        """Prefill one sequence and scatter its cache into ``block_row``."""
        first, seq_cache = self.prefill(tokens, true_lens)
        cache = self.model.insert_cache(cache, seq_cache, slot,
                                        self._t(block_row, torch.int64))
        return first, cache

    @torch.inference_mode()
    def decode(self, token, pos, active, cache, block_table):
        """One masked decode step over all slots -> (greedy next token (B,)
        int32 tensor, cache updated in place)."""
        batch = {"token": self._t(token, torch.int32),
                 "pos": self._t(pos, torch.int32),
                 "active": self._t(active, torch.bool),
                 "block_table": self._table(block_table)}
        logits, cache = self.model.decode_step(self.params, batch, cache)
        return torch.argmax(logits, -1).to(torch.int32), cache
