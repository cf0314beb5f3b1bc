"""Single-device execution for the serving engine: params and the paged
cache on one device, and the serving entry points — prefill, fused
prefill + insert, the decode step and the horizon-M decode round.

On a CUDA device the decode step and the decode round each run as one
captured CUDA graph, the counterpart of the JAX package's jitted decode
executables: the host uploads a round's inputs into fixed device buffers
and replays the graph, instead of issuing a few thousand small launches.
A graph reads and writes fixed addresses, so the executor owns them all
for its life: one paged pool (``init_cache`` zeroes it in place), one
block-table buffer, and the static token / pos / active / remaining / EOS
inputs and token outputs.  On the CPU the same bodies run eagerly; that is
the plain version the parity tests compare.  The cache is updated in place
where the JAX package donated it.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import psi
from repro_torch.kernels import ops
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


class _Upload:
    """Host-to-device copies of int32 data through one staging buffer,
    pinned on a CUDA device so the copy runs on the stream without a host
    sync.  The host fills the buffer again only after its previous copy
    has run, so a copy still queued behind device work never reads newer
    data."""

    def __init__(self, shape, device: torch.device):
        cuda = device.type == "cuda"
        self._buf = torch.empty(shape, dtype=torch.int32, pin_memory=cuda)
        self._done = torch.cuda.Event() if cuda else None
        self._queued = False

    def host(self) -> np.ndarray:
        """The staging buffer as an ndarray, free to write."""
        if self._queued:
            self._done.synchronize()
            self._queued = False
        return self._buf.numpy()

    def copy(self, dst: torch.Tensor, rows=None) -> None:
        """Copy the staging buffer (or its ``rows``) into ``dst``."""
        if rows is None:
            dst.copy_(self._buf, non_blocking=True)
        else:
            for r in rows:
                dst[r].copy_(self._buf[r], non_blocking=True)
        if self._done is not None:
            self._done.record(torch.cuda.current_stream(dst.device))
            self._queued = True


class DeviceBlockTable:
    """Host-mirrored block table over one fixed int32 device ``buffer``
    (max_batch, n_bt).  The host mirror is authoritative and written like an
    ndarray; :meth:`device` copies it into the buffer one dirty row at a
    time (all of it when most rows changed, or when the buffer last held
    another table).  The buffer never moves, so a captured decode graph
    reads the current table."""

    def __init__(self, buffer: torch.Tensor):
        self.host = np.full(tuple(buffer.shape), -1, np.int32)
        self._device = buffer
        self._upload = _Upload(self.host.shape, buffer.device)
        self._dirty = set()
        self._stale = True             # the buffer does not hold this table
        self.stats = {"reuses": 0, "row_updates": 0, "full_uploads": 0}

    def __getitem__(self, idx):
        return self.host[idx]

    def __setitem__(self, idx, val):
        self.host[idx] = val
        slot = idx[0] if isinstance(idx, tuple) else idx
        for s in np.atleast_1d(np.asarray(slot)).reshape(-1):
            self._dirty.add(int(s))

    def invalidate(self) -> None:
        """Mark the buffer as holding another table: the next
        :meth:`device` uploads the whole mirror."""
        self._stale = True

    def device(self) -> torch.Tensor:
        if self._stale or 2 * len(self._dirty) >= self.host.shape[0]:
            self._upload.host()[...] = self.host
            self._upload.copy(self._device)
            self.stats["full_uploads"] += 1
        elif self._dirty:
            rows = sorted(self._dirty)
            stage = self._upload.host()
            stage[rows] = self.host[rows]
            self._upload.copy(self._device, rows)
            self.stats["row_updates"] += len(rows)
        else:
            self.stats["reuses"] += 1
        self._dirty.clear()
        self._stale = False
        return self._device


class RoundTokens:
    """A decode round's (M, B) int32 tokens on their way to the host.  On a
    CUDA device they are copied into a fresh pinned buffer behind the round
    on the stream, and an event marks the copy's end: the next round can
    run (and overwrite the graph's output) while the host has yet to read
    these.  ``np.asarray`` waits for the copy."""

    def __init__(self, toks: torch.Tensor):
        if toks.is_cuda:
            self._host = torch.empty(toks.shape, dtype=toks.dtype,
                                     pin_memory=True)
            self._host.copy_(toks, non_blocking=True)
            self._ready = torch.cuda.Event()
            self._ready.record(torch.cuda.current_stream(toks.device))
        else:
            self._host, self._ready = toks.clone(), None

    def numpy(self) -> np.ndarray:
        if self._ready is not None:
            self._ready.synchronize()
        return self._host.numpy()

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a if dtype is None else a.astype(dtype)


def _host_array(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a)


class Executor:
    """Owns the device, the params on it, the paged pool, the decode graphs
    and the serving entry points."""

    def __init__(self, cfg, params, *, max_batch: int, max_seq: int,
                 device=None, n_blocks: int = None, decode_horizon: int = 1):
        self.model = build_model(cfg)
        self.device = resolve_device(device)
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.decode_horizon = int(decode_horizon)
        if self.decode_horizon < 1:
            raise ValueError(f"decode_horizon={decode_horizon} must be >= 1")
        cfg.resolved_cache_layout                 # paged dense stacks only
        self.block_size = cfg.cache_block_size
        self.n_bt = kvc.table_width(max_seq, self.block_size)
        self.n_blocks = (n_blocks if n_blocks is not None
                         else max_batch * self.n_bt)
        self.params = params_to(params, self.device)
        self.prefill_calls = 0          # model forwards over a prompt batch
        B, dev = max_batch, self.device
        self._cache = None
        # the decode graphs' fixed inputs: rows token, pos, active (0/1)
        # and remaining budget per slot; the EOS id; the block table
        self._inp = torch.zeros((4, B), dtype=torch.int32, device=dev)
        self._inp_upload = _Upload((4, B), dev)
        self._eos = torch.full((), -1, dtype=torch.int32, device=dev)
        self._eos_id = -1
        self._bt = torch.full((B, self.n_bt), -1, dtype=torch.int32,
                              device=dev)
        self._bt_holder = None          # the DeviceBlockTable _bt holds
        self._host_table = self.make_block_table()  # for raw host tables
        # ... and their fixed outputs
        self._next = torch.zeros((B,), dtype=torch.int32, device=dev)
        self._toks = torch.zeros((self.decode_horizon, B), dtype=torch.int32,
                                 device=dev)
        # a round's carry is the input rows themselves: the round writes its
        # exit state there, so the next round starts from it with no upload
        self.carry = {"token": self._inp[0].view(B, 1),
                      "pos": self._inp[1].view(B, 1),
                      "active": self._inp[2], "remaining": self._inp[3]}
        self._graphs = {}               # name -> (CUDAGraph, launches)

    def _t(self, a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(self.device)

    def init_cache(self) -> kvc.KVCache:
        """The executor's paged pool: allocated at the first call, zeroed
        in place at every later one.  The decode graphs are captured
        against its tensors, so it never moves."""
        if self._cache is None:
            self._cache = self.model.init_cache(
                self.max_batch, self.max_seq, device=self.device,
                block_size=self.block_size, n_blocks=self.n_blocks)
        else:
            for layer in self._cache.kv:
                for t in layer.values():
                    t.zero_()
        return self._cache

    def make_block_table(self) -> DeviceBlockTable:
        return DeviceBlockTable(self._bt)

    def graph_counts(self) -> dict:
        """Captured decode graphs by entry point (none on the CPU): the
        counterpart of the JAX package's compiled decode executables."""
        return {name: int(name in self._graphs)
                for name in ("decode", "decode_multi")}

    # ------------------------------------------------------------ uploads
    def _check_pool(self, cache) -> None:
        if cache is None or cache is not self._cache:
            raise ValueError("decode runs on the executor's own pool: pass "
                             "the cache that init_cache() returned")

    def _put(self, token, pos, active, remaining) -> None:
        """Upload the step inputs, unless they are the carry the last round
        left in the input rows (then they are already there)."""
        vals = (token, pos, active, remaining)
        keys = ("token", "pos", "active", "remaining")
        if all(v is self.carry[k] for v, k in zip(vals, keys)):
            return
        stage = self._inp_upload.host()
        for i, v in enumerate(vals):
            stage[i] = _host_array(v).reshape(-1)
        self._inp_upload.copy(self._inp)

    def _table(self, block_table) -> None:
        if isinstance(block_table, DeviceBlockTable):
            table = block_table
            if table._device is not self._bt:
                raise ValueError("the block table belongs to another "
                                 "executor; use make_block_table()")
        else:
            table = self._host_table
            table.host[...] = _host_array(block_table)
            table.invalidate()
        if table is not self._bt_holder:
            table.invalidate()
            self._bt_holder = table
        table.device()

    # -------------------------------------------------------------- graphs
    def _batch(self) -> dict:
        B = self.max_batch
        return {"token": self._inp[0].view(B, 1),
                "pos": self._inp[1].view(B, 1),
                "active": self._inp[2] != 0, "block_table": self._bt}

    def _decode_body(self) -> None:
        logits, _ = self.model.decode_step(self.params, self._batch(),
                                           self._cache)
        self._next.copy_(torch.argmax(logits, -1))

    def _multi_body(self) -> None:
        batch = self._batch()
        batch.update(remaining=self._inp[3], eos_id=self._eos)
        toks, carry, _ = self.model.decode_scan(self.params, batch,
                                                self._cache,
                                                self.decode_horizon)
        self._toks.copy_(toks)
        self._inp.copy_(torch.stack([
            carry["token"][:, 0], carry["pos"][:, 0],
            carry["active"].to(torch.int32), carry["remaining"]]))

    def _run(self, name: str, body) -> None:
        """Run ``body`` eagerly on the CPU; on a CUDA device replay its
        graph, captured at the first call, and add the launches the capture
        recorded to the kernels' counts."""
        if self.device.type != "cuda":
            body()
            return
        if name not in self._graphs:
            self._graphs[name] = self._capture(body)
        graph, launches = self._graphs[name]
        graph.replay()
        ops.add_launches(launches)

    def _capture(self, body):
        """Capture ``body`` into a CUDA graph over the fixed buffers.  One
        eager run comes first, on a side stream, with every row inactive
        (those write only their scratch blocks) and the input rows restored
        after it: kernels load and lazy state is set up outside the capture.
        The capture's own calls launch nothing, so the counts they add are
        taken back; a failed capture raises."""
        stream = torch.cuda.current_stream(self.device)
        saved = self._inp.clone()
        self._inp[2].zero_()
        side = torch.cuda.Stream(self.device)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            body()
        stream.wait_stream(side)
        self._inp.copy_(saved)
        before = ops.launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            body()
        after = ops.launch_counts()
        launches = {k: after[k] - before[k] for k in after}
        ops.add_launches({k: -n for k, n in launches.items()})
        return graph, launches

    # --------------------------------------------------------- entry points
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
        int32 tensor, cache updated in place).  ``cache`` is the executor's
        pool; on a CUDA device the step is a graph replay."""
        self._check_pool(cache)
        self._put(token, pos, active, 0)
        self._table(block_table)
        self._run("decode", self._decode_body)
        return self._next.clone(), cache

    @torch.inference_mode()
    def decode_multi(self, token, pos, active, remaining, cache,
                     block_table, eos_id: int = -1):
        """One horizon-M decode round (``decode_horizon > 1``): M masked
        steps with EOS and budget retirement on the device
        (``Model.decode_scan``).

        ``token`` / ``pos`` / ``active`` / ``remaining`` are host arrays
        (uploaded), or :attr:`carry` as the previous round left it (nothing
        to upload).  ``eos_id`` -1 disables EOS retirement; a new value
        needs no new graph.  Returns (:class:`RoundTokens` of the (M, B) raw
        step tokens, :attr:`carry` — the round's exit state, live until the
        next call — and the cache)."""
        if self.decode_horizon < 2:
            raise ValueError("decode_multi needs decode_horizon > 1 at "
                             "construction")
        self._check_pool(cache)
        self._put(token, pos, active, remaining)
        if int(eos_id) != self._eos_id:
            self._eos.fill_(int(eos_id))
            self._eos_id = int(eos_id)
        self._table(block_table)
        self._run("decode_multi", self._multi_body)
        return RoundTokens(self._toks), self.carry, cache
