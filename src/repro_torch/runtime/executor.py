"""Single-device execution for the serving engine: params and the decode
cache (the paged pool or the dense per-slot slab) on one device, and the
serving entry points — prefill, fused prefill + insert, the burst insert,
the decode step, the horizon-M decode round and the self-speculative draft
and verify passes (paged only).

On a CUDA device the decode step, the decode round, the draft and the
verify each run as one captured CUDA graph, the counterpart of the JAX
package's jitted decode executables: the host uploads a round's inputs
into fixed device buffers and replays the graph, instead of issuing a few
thousand small launches.  A graph reads and writes fixed addresses, so the
executor owns them all for its life: one cache (``init_cache`` resets it
in place), one block-table buffer (paged), and the static token / pos /
active / remaining / EOS inputs and token outputs (the drafts and verdicts
included).  On the CPU the same bodies run eagerly; that is
the plain version the parity tests compare.  The cache is updated in place
where the JAX package donated it, a hybrid's recurrent state and an SSM's
state included (an inactive slot's state is frozen by a ``torch.where``
inside the graph).  M-RoPE's three equal position streams are views of
the fixed pos row, and whisper's sinusoidal rows are computed from it,
both by the model inside the graph; whisper's ``enc_out`` is a cache
tensor with a fixed address, written at insert and read in place.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import psi, quantizer
from repro_torch.kernels import ops
from repro_torch.models import attention, build_model, kvcache as kvc
from repro_torch.runtime import parallel
from repro_torch.runtime import sharding as shr
from repro_torch.runtime.elastic import make_mesh_from_plan, plan_remesh
from repro_torch.runtime.straggler import StragglerMonitor


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
    (rows, n_bt).  The host mirror is authoritative and written like an
    ndarray; :meth:`device` copies it into the buffer one dirty row at a
    time (all of it when most rows changed, or when the buffer last held
    another table).  The buffer never moves, so a captured decode graph
    reads the current table.

    A rank on a mesh mirrors all ``n_slots`` rows in global block ids and
    uploads only its window [``row0``, ``row0`` + rows), mapped through
    ``ids`` into its own pool's ids (``MeshShare.local_block_ids``); by
    default the window is the whole mirror and ids are kept."""

    def __init__(self, buffer: torch.Tensor, n_slots: int = 0,
                 row0: int = 0, ids=None):
        rows, n_bt = buffer.shape
        self.host = np.full((n_slots or rows, n_bt), -1, np.int32)
        self._row0, self._rows = row0, rows
        self._ids = ids if ids is not None else (lambda a: a)
        self._device = buffer
        self._upload = _Upload(tuple(buffer.shape), buffer.device)
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
        lo, n = self._row0, self._rows
        window = self.host[lo:lo + n]
        rows = sorted(s - lo for s in self._dirty if lo <= s < lo + n)
        if self._stale or 2 * len(rows) >= n:
            self._upload.host()[...] = self._ids(window)
            self._upload.copy(self._device)
            self.stats["full_uploads"] += 1
        elif rows:
            stage = self._upload.host()
            stage[rows] = self._ids(window[rows])
            self._upload.copy(self._device, rows)
            self.stats["row_updates"] += len(rows)
        else:
            self.stats["reuses"] += 1
        self._dirty.clear()
        self._stale = False
        return self._device


class RoundTokens:
    """A graph's int32 token output (a round's (M, B) tokens, the (B, k)
    drafts or verdicts) on its way to the host.  On a CUDA device it is
    copied into a fresh pinned buffer behind the graph on the stream, and
    an event marks the copy's end: later work can run (and overwrite the
    graph's output) while the host has yet to read it.  ``np.asarray``
    waits for the copy only.  ``source`` is the device buffer copied."""

    def __init__(self, toks: torch.Tensor):
        self.source = toks
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
    """Owns the device, the params on it, the decode cache in the config's
    resolved layout (the paged pool, or the dense slab: no block table),
    the decode graphs and the serving entry points.

    ``speculative=(bits, k)`` adds the self-speculative pair: a draft tree
    (:func:`quantizer.draft_param_tree` of the serving params at ``bits``)
    placed on the device once, and the fixed (B, k) drafts and verdicts.

    ``mesh`` (a ``DeviceMesh`` over the ranks of an initialised process
    group; None: this process alone, today's path) serves SPMD: params,
    the cache and the step inputs are placed as :func:`sharding.local_shard`
    of their specs (a paged pool keeps ``local_batch`` scratch blocks of its
    own; a mamba ``in_proj`` is resliced by channel, see
    :class:`sharding.LeafPlacer`), this rank computes its slot shard's rows
    only (and, where :func:`sharding.tp_enabled` holds, its share of the
    heads and FFN channels, its experts or its columns of every expert,
    its SSM channels), and every entry point's tokens are all-gathered, so
    the host-facing API is the single process's: global slots, global
    block ids, (B,) tokens.  See :class:`parallel.MeshShare`.
    ``params_are_local=True``: ``params`` is already this rank's share (a
    rank-local ``Model.init(share=...)``); its shapes are checked against
    the placement, and :meth:`remesh` is refused."""

    def __init__(self, cfg, params, *, max_batch: int, max_seq: int,
                 device=None, n_blocks: int = None, decode_horizon: int = 1,
                 speculative=None, mesh=None, params_are_local=False):
        self.cfg = cfg
        self.mesh = mesh
        if params_are_local and mesh is None:
            raise ValueError("params_are_local needs a mesh")
        self._params_are_local = bool(params_are_local)
        self.device = resolve_device(device)
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.decode_horizon = int(decode_horizon)
        if self.decode_horizon < 1:
            raise ValueError(f"decode_horizon={decode_horizon} must be >= 1")
        self.layout = cfg.resolved_cache_layout
        self.paged = self.layout == kvc.PAGED
        if self.paged:
            self.block_size = cfg.cache_block_size
            self.n_bt = kvc.table_width(max_seq, self.block_size)
            self.n_blocks = (n_blocks if n_blocks is not None
                             else max_batch * self.n_bt)
        else:
            self.block_size = self.n_bt = self.n_blocks = 0
            if n_blocks is not None:
                raise ValueError("n_blocks only applies to the paged cache "
                                 "layout (cfg.resolved_cache_layout)")
        self.speculative = tuple(speculative) if speculative else None
        self.spec_bits = self.spec_k = 0
        if self.speculative is not None:
            bits, k = self.speculative
            if not self.paged:
                raise ValueError("speculative decoding needs the paged "
                                 "cache layout (cfg.resolved_cache_layout)")
            if cfg.rope == "mrope":
                raise ValueError("speculative verify does not support "
                                 "mrope position encoding")
            if not 1 <= k <= self.block_size:
                raise ValueError(
                    f"speculative k={k} must be in [1, block_size="
                    f"{self.block_size}]: the k-token verify scatter needs "
                    f"distinct in-block offsets")
            if not any(isinstance(leaf, psi.QuantizedTensor)
                       for leaf in quantizer.tree_leaves(params)):
                raise ValueError("speculative decoding derives its draft "
                                 "from PSI-quantized serving params; "
                                 "quantize first (--quant psiN)")
            if self.decode_horizon > 1:
                raise ValueError(
                    "--decode-horizon > 1 does not compose with "
                    "--speculative: a speculative round is already a "
                    "multi-token unit with its own acceptance; pick one "
                    "(drop --speculative or set the horizon to 1)")
            self.spec_bits, self.spec_k = int(bits), int(k)
        self._share = None
        self.mesh_size = 1
        self.n_slot_shards, self.n_block_shards = 1, 1
        self.slot_shards = np.zeros((max_batch,), np.int64)
        self.block_shards = (np.zeros((self.n_blocks,), np.int64)
                             if self.paged else None)
        self.local_batch, self._local_blocks = max_batch, self.n_blocks
        self.local_cfg = cfg            # this rank's share of the model
        self.monitor = None
        self._ring_split = 1            # ranks a dense KV ring splits over
        self.draft_params = None
        self.blocks_copied = 0          # pool blocks copied across shards
        if mesh is None:
            self.model = build_model(cfg)
            # a tied PSI table's head is transposed here, once, on the device
            self.params = self.model.serving_params(params_to(params,
                                                              self.device))
            # derived on the device from the placed codes: one copy, no
            # host trip
            if self.speculative is not None:
                self.draft_params = quantizer.draft_param_tree(
                    self.params, self.spec_bits)
        else:
            self._place_on_mesh(cfg, params, mesh)
        self.prefill_calls = 0          # model forwards over a prompt batch
        self.prefill_headless = 0       # ... of them without the lm-head
        B, dev = self.local_batch, self.device
        self._cache = None
        # the decode graphs' fixed inputs: rows token, pos, active (0/1)
        # and remaining budget per slot; the EOS id; the block table
        self._inp = torch.zeros((4, B), dtype=torch.int32, device=dev)
        self._inp_upload = _Upload((4, B), dev)
        self._rows = None               # host copy of the rows' last upload
        self._eos = torch.full((), -1, dtype=torch.int32, device=dev)
        self._eos_id = -1
        self._bt = self._host_table = None
        self._bt_holder = None          # the DeviceBlockTable _bt holds
        if self.paged:
            self._bt = torch.full((B, self.n_bt), -1, dtype=torch.int32,
                                  device=dev)
            self._host_table = self.make_block_table()  # raw host tables
        # ... and their fixed outputs
        self._next = torch.zeros((B,), dtype=torch.int32, device=dev)
        self._toks = torch.zeros((self.decode_horizon, B), dtype=torch.int32,
                                 device=dev)
        # the speculative pair's: the draft writes drafts, the verify reads
        # them and writes verdicts
        self._drafts = torch.zeros((B, self.spec_k), dtype=torch.int32,
                                   device=dev)
        self._verdicts = torch.zeros((B, self.spec_k), dtype=torch.int32,
                                     device=dev)
        # a round's carry is the input rows themselves: the round writes its
        # exit state there, so the next round starts from it with no upload
        self.carry = {"token": self._inp[0].view(B, 1),
                      "pos": self._inp[1].view(B, 1),
                      "active": self._inp[2], "remaining": self._inp[3]}
        self._graphs = {}       # name -> (CUDAGraph, launches, collectives)
        self._drafts_out = None         # the last gathered drafts (mesh)

    def _place_on_mesh(self, cfg, params, mesh) -> None:
        """This rank's share of params and cache on ``mesh``; the shard
        maps the scheduler partitions over."""
        share = parallel.MeshShare(cfg, mesh, self.max_batch,
                                   self.n_blocks if self.paged else None)
        self._share = share
        self._given_params = params
        self.mesh_size = share.size
        self.n_slot_shards = share.n_slot_shards
        self.slot_shards = share.slot_shards
        self.n_block_shards = share.n_block_shards
        if self.paged:
            self.block_shards = share.block_shards
        self.local_batch = share.local_batch
        self._local_blocks = share.local_blocks
        self.local_cfg = share.local_cfg(cfg)
        if (share.tp and not self.paged and shr.kv_seq_axis(
                cfg, mesh, self.max_batch,
                attention.cache_extent(cfg, self.max_seq)) == "model"):
            # KV heads that do not split over "model": the dense ring's
            # positions do (sharding._kv_layout), rank r holding slots
            # [r C/m, (r+1) C/m)
            self._ring_split = share.tp_size
            self.local_cfg = dataclasses.replace(
                self.local_cfg, kv_seq_split=self._ring_split)
        self.model = build_model(self.local_cfg)
        # shr.LeafPlacer cuts what local_shard cuts, but for a mamba
        # in_proj: its (d, 2 d_inner) columns are two halves, x and z, and
        # a rank computes on its channels of both (a contiguous chunk of
        # the columns, as GSPMD lays the spec out, would give one rank all
        # of x and the other all of z); and for a packed expert block,
        # whose planes keep the expert dim where the codes have it
        placer = shr.LeafPlacer(cfg, mesh, share.coord, "serve")
        if self._params_are_local:
            glob = self._global_meta(cfg, params)
            self._check_local_params(placer, glob, params)
            local = params
        else:
            glob = params
            local = placer.place_tree(params)
        specs = placer.specs(glob)
        local = self.model.serving_params(params_to(local, self.device))
        split = self._ring_split > 1
        self.params = share.wrap_tp(cfg, local, specs, ring_split=split)
        if self.speculative is not None:
            # the draft views of the rank's codes, wrapped exactly as the
            # target's leaves (column, row, gather)
            self.draft_params = share.wrap_tp(
                cfg, quantizer.draft_param_tree(local, self.spec_bits),
                specs, ring_split=split)
        self._check_cache_layout(cfg, mesh)
        if share.size > 1:
            self.monitor = StragglerMonitor(n_hosts=share.size)

    @staticmethod
    def _global_meta(cfg, local):
        """The global param tree as meta tensors, each leaf quantized as
        this rank's chunk of it is (its width, packed or not)."""
        def at(path):
            node = local
            for k in path.split("/"):
                node = node[int(k)] if isinstance(node, list) else node[k]
            return node

        tree = {"layers": [{} for _ in range(cfg.n_layers)]}
        if cfg.family == "encdec":
            tree["encoder"] = [{} for _ in range(cfg.n_enc_layers)]
        for path, shape, _ in build_model(cfg).param_specs():
            leaf = torch.empty(shape, dtype=torch.float32, device="meta")
            mine = at(path)
            if isinstance(mine, psi.QuantizedTensor):
                leaf = quantizer.quantize_leaf(path, leaf, mine.fmt.bits,
                                               pack=mine.packed)
            node = tree
            keys = path.split("/")
            for k in keys[:-1]:
                node = node[int(k)] if isinstance(node, list) else \
                    node.setdefault(k, {})
            node[keys[-1]] = leaf
        return tree

    @staticmethod
    def _check_local_params(placer, glob, local) -> None:
        """Every given chunk has the shape the placement cuts from the
        global leaf."""
        def one(path, g, mine):
            name = "/".join(map(str, path))
            want = placer.place(name, g)
            pairs = ([(want.data, mine.data), (want.scale, mine.scale)]
                     if isinstance(want, psi.QuantizedTensor)
                     else [(want, mine)])
            for w, m in pairs:
                if tuple(w.shape) != tuple(m.shape):
                    raise ValueError(
                        f"params_are_local: {name} is {tuple(m.shape)} but "
                        f"this rank's share is {tuple(w.shape)}")
        shr.map_tree(one, glob, local)

    def _check_cache_layout(self, cfg, mesh) -> None:
        """The local cache must be :func:`sharding.local_shard` of the
        global cache's specs (a paged pool plus its local scratch blocks; a
        dense KV ring split over "model" included)."""
        B, share = self.max_batch, self._share
        glob = build_model(cfg).init_cache(
            B, self.max_seq, device="meta",
            block_size=self.block_size or None,
            n_blocks=self.n_blocks if self.paged else None,
            layout=self.layout)
        mine = self.model.init_cache(
            self.local_batch, self.max_seq, device="meta",
            block_size=self.block_size or None,
            n_blocks=self._local_blocks if self.paged else None,
            layout=self.layout)
        specs = shr.cache_specs(cfg, mesh, glob)
        pairs = [(f"{i}/{k}", t, layer_s[k], mine.kv[i][k])
                 for i, (layer, layer_s) in enumerate(zip(glob.kv, specs.kv))
                 for k, t in layer.items()]
        if glob.enc_out is not None:
            pairs.append(("enc_out", glob.enc_out, specs.enc_out,
                          mine.enc_out))
        for name, t, spec, loc in pairs:
            want = tuple(shr.local_shard(t, spec, mesh, share.coord).shape)
            got = tuple(loc.shape)
            if self.paged and self.n_block_shards > 1:
                got = (got[0] - self.local_batch,) + got[1:]
            if want != got:
                raise RuntimeError(
                    f"cache leaf {name}: spec {spec} gives this rank "
                    f"{want}, the port computes {got}")

    # ------------------------------------------------------------ elastic
    @classmethod
    def from_devices(cls, cfg, params, *, max_batch: int, max_seq: int,
                     devices=None, model_parallel: int = 1, pods=None,
                     **kwargs):
        """Build on the largest valid (data, model) mesh over the ranks
        ``devices`` (default every rank of the process group), from
        :func:`elastic.plan_remesh`.  Every rank of the group calls it; a
        rank the plan leaves out (a hot spare) gets None."""
        import torch.distributed as dist
        ranks = (list(devices) if devices is not None
                 else list(range(dist.get_world_size())))
        plan = plan_remesh(len(ranks), model_parallel, pods=pods)
        mesh = make_mesh_from_plan(plan, ranks)
        if mesh.get_coordinate() is None:
            return None
        return cls(cfg, params, max_batch=max_batch, max_seq=max_seq,
                   mesh=mesh, **kwargs)

    def mesh_ranks(self) -> list:
        return [] if self._share is None else list(self._share.ranks)

    def remesh(self, devices=None, model_parallel: int = None):
        """Rebuild this executor on the ranks ``devices`` (default this
        mesh's ranks) with the plan of :func:`elastic.plan_remesh`: the
        params are cut anew (resharding is the load path).  A plan that
        matches the mesh on the same ranks in the same order returns self;
        a survivor set with a swapped rank rebuilds.  The rebuild keeps
        ``n_blocks``, ``speculative`` and ``decode_horizon``.  Every rank
        of the mesh and of ``devices`` calls it; a rank the new plan drops
        gets None."""
        if self._share is None:
            raise ValueError("remesh needs an executor built on a mesh")
        if self._params_are_local:
            raise ValueError("remesh cuts the global params anew: this "
                             "executor was given this rank's share only")
        axes = self._share.axes
        ranks = list(devices) if devices is not None else self.mesh_ranks()
        mp = (model_parallel if model_parallel is not None
              else axes.get("model", 1))
        plan = plan_remesh(len(ranks), mp, pods=axes.get("pod", None))
        if (plan.shape == tuple(axes.values())
                and plan.axis_names == tuple(axes)
                and [int(r) for r in ranks[:plan.n_devices]]
                == self.mesh_ranks()):
            return self
        mesh = make_mesh_from_plan(plan, ranks)
        if mesh.get_coordinate() is None:
            return None
        return Executor(self.cfg, self._given_params,
                        max_batch=self.max_batch, max_seq=self.max_seq,
                        device=self.device, mesh=mesh,
                        n_blocks=self.n_blocks if self.paged else None,
                        speculative=self.speculative,
                        decode_horizon=self.decode_horizon)

    def observe_step(self, step_times):
        """Feed per-rank step times to the straggler monitor; its report,
        or None in a single process."""
        if self.monitor is None:
            return None
        return self.monitor.observe(step_times)

    def agree_time(self, t: float) -> float:
        """Rank 0's clock reading ``t`` on every rank of the mesh (``t``
        itself without one): the serve loop admits on it."""
        return t if self._share is None else self._share.agree_time(t)

    def _t(self, a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(self.device)

    def init_cache(self) -> kvc.KVCache:
        """The executor's cache (the paged pool or the dense slab):
        allocated at the first call, reset in place at every later one
        (zeros, every dense ``k_pos`` -1, and whisper's ``enc_out``
        zeros).  The decode graphs are captured against its tensors, so
        it never moves."""
        if self._cache is None:
            self._cache = self.model.init_cache(
                self.local_batch, self.max_seq, device=self.device,
                block_size=self.block_size or None,
                n_blocks=self._local_blocks if self.paged else None,
                layout=self.layout)
        else:
            for layer in self._cache.kv:
                for name, t in layer.items():
                    if name == "k_pos":
                        t.fill_(-1)
                    else:
                        t.zero_()
            if self._cache.enc_out is not None:
                self._cache.enc_out.zero_()
        return self._cache

    def make_block_table(self) -> DeviceBlockTable:
        if not self.paged:
            raise ValueError("DeviceBlockTable mirrors the paged layout's "
                             "block table; this executor is dense")
        if self._share is not None:
            sh = self._share
            return DeviceBlockTable(self._bt, self.max_batch, sh.row0,
                                    sh.local_block_ids)
        return DeviceBlockTable(self._bt)

    def graph_counts(self) -> dict:
        """Captured decode graphs by entry point (none on the CPU): the
        counterpart of the JAX package's compiled decode executables."""
        return {name: int(name in self._graphs)
                for name in ("decode", "decode_multi", "draft", "verify")}

    def spec_cache_sizes(self) -> dict:
        """The speculative graph contract: on the card exactly one draft
        and one verify graph, and no plain decode graph (all 0 on the
        CPU)."""
        counts = self.graph_counts()
        return {k: counts[k] for k in ("draft", "verify", "decode")}

    # ------------------------------------------------------------ uploads
    def _check_pool(self, cache) -> None:
        if cache is None or cache is not self._cache:
            raise ValueError("decode runs on the executor's own pool: pass "
                             "the cache that init_cache() returned")

    def _put(self, token, pos, active, remaining) -> None:
        """Upload the step inputs, unless they are the carry the last round
        left in the input rows, or the values the rows were last given
        (then they are already there: a verify after its draft uploads
        nothing)."""
        vals = (token, pos, active, remaining)
        keys = ("token", "pos", "active", "remaining")
        if all(v is self.carry[k] for v, k in zip(vals, keys)):
            return
        rows = np.zeros((4, self.local_batch), np.int32)
        for i, v in enumerate(vals):
            v = _host_array(v).reshape(-1)
            if self._share is not None and v.size == self.max_batch:
                v = self._share.local_rows(v)
            rows[i] = v
        if self._rows is not None and np.array_equal(rows, self._rows):
            return
        self._inp_upload.host()[...] = rows
        self._inp_upload.copy(self._inp)
        self._rows = rows

    def _table(self, block_table) -> None:
        if not self.paged:
            if block_table is not None:
                raise ValueError("a dense executor takes no block table")
            return
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
        B = self.local_batch
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

    def _draft_body(self) -> None:
        """k greedy decode steps over the draft params from the input rows,
        each row's active flag held for all k (an inactive row writes only
        its scratch block); draft KV lands at [pos, pos + k)."""
        batch = self._batch()
        tok, pos = batch["token"], batch["pos"]
        drafts = []
        for _ in range(self.spec_k):
            logits, _ = self.model.decode_step(
                self.draft_params, dict(batch, token=tok, pos=pos),
                self._cache)
            tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
            pos = pos + 1
            drafts.append(tok[:, 0])
        self._drafts.copy_(torch.stack(drafts, 1))

    def _verify_body(self) -> None:
        """One k-token verify at the target width over [token, drafts[:,
        :k-1]], built on the device from the drafts buffer."""
        batch = self._batch()
        tokens = torch.cat([batch["token"],
                            self._drafts[:, :self.spec_k - 1]], 1)
        logits, _ = self.model.verify_step(
            self.params, {"tokens": tokens, "pos0": batch["pos"],
                          "active": batch["active"],
                          "block_table": self._bt}, self._cache)
        self._verdicts.copy_(torch.argmax(logits, -1))

    def _run(self, name: str, body) -> None:
        """Run ``body`` eagerly on the CPU; on a CUDA device replay its
        graph, captured at the first call, and add the launches the capture
        recorded to the kernels' counts."""
        if self.device.type != "cuda":
            body()
            return
        if name not in self._graphs:
            self._graphs[name] = self._capture(body)
        graph, launches, colls = self._graphs[name]
        graph.replay()
        ops.add_launches(launches)
        if colls:
            parallel.add_collectives(colls)

    def _capture(self, body):
        """Capture ``body`` into a CUDA graph over the fixed buffers.  One
        eager run comes first, on a side stream, with every row inactive
        (those write only their scratch blocks, or nothing on the dense
        slab) and the input rows restored
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
        before = {**ops.launch_counts(), **ops.route_launch_counts()}
        cbefore = parallel.collective_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            body()
        after = {**ops.launch_counts(), **ops.route_launch_counts()}
        launches = {k: after[k] - before[k] for k in after}
        ops.add_launches({k: -n for k, n in launches.items()})
        cafter = parallel.collective_counts()
        colls = {k: cafter[k] - cbefore[k] for k in cafter
                 if cafter[k] != cbefore[k]}
        parallel.add_collectives({k: -n for k, n in colls.items()})
        return graph, launches, colls

    # --------------------------------------------------------- entry points
    @torch.inference_mode()
    def prefill(self, tokens, true_lens, pos0: int = 0, ctx_kv=None,
                emit: bool = True, row_lens=None):
        """(B, Sb) right-padded prompts -> (first greedy token (B,) int32
        tensor, or None with ``emit=False``; dense per-sequence cache at
        the bucketed extent (paged) or at ``max_seq`` (dense: a slot's
        extent)).  ``pos0`` / ``ctx_kv``: a suffix prefill; ``row_lens``: a
        burst's per-row attention extents (``Model.prefill``).  An
        encoder-decoder's encoder runs over the model's default input,
        zero frames (the stub frontend), one set a row.  Counts one model
        forward, and one forward without the lm-head when ``emit`` is
        False."""
        self.prefill_calls += 1
        self.prefill_headless += int(not emit)
        logits, cache = self.model.prefill(
            self.params, self._t(tokens, torch.int32),
            cache_len=None if self.paged else self.max_seq,
            true_lens=self._t(true_lens, torch.int64), pos0=pos0,
            ctx_kv=ctx_kv, emit_logits=emit, row_lens=row_lens)
        if not emit:
            return None, cache
        return torch.argmax(logits, -1).to(torch.int32), cache

    def _gather_slot_token(self, first, slot: int) -> torch.Tensor:
        """On a mesh: the slot owner's first token, (1,), on every rank
        (the owner puts it in its row of a (local_batch,) gather)."""
        share = self._share
        vec = torch.zeros((self.local_batch,), dtype=torch.int32,
                          device=self.device)
        if first is not None:
            vec[int(slot) - share.row0] = first[0]
        return share.gather(vec)[int(slot):int(slot) + 1]

    @torch.inference_mode()
    def prefill_insert(self, tokens, true_lens, cache, slot: int,
                       block_row=None, ctx_ids=None, emit: bool = True):
        """Prefill one sequence and scatter its cache into ``block_row``
        (paged), or write it into the slot's row of the slab (dense).

        ``ctx_ids`` (nctx,) names pool blocks holding the KV of absolute
        positions ``[0, nctx * block_size)``: ``tokens`` then hold only the
        suffix after them, which attends over that context and scatters
        into ``block_row[nctx:]`` only — the context blocks may be shared
        with other requests and are never written.  ``emit=False`` (a
        chunk that is not the last) skips the lm-head and returns None."""
        self._check_pool(cache)
        if ctx_ids is None and not emit:
            raise ValueError("emit=False is for a chunk of the context "
                             "path: pass ctx_ids (possibly empty)")
        share = self._share
        if share is not None:
            # only the slot's shard computes; every rank gets its token
            first = None
            if share.owns(slot):
                first, cache = self._prefill_insert_local(
                    tokens, true_lens, cache, int(slot) - share.row0,
                    None if block_row is None
                    else share.local_block_ids(block_row),
                    None if ctx_ids is None
                    else share.local_block_ids(ctx_ids), emit)
            if not emit:
                return None, cache
            return self._gather_slot_token(first, slot), cache
        return self._prefill_insert_local(tokens, true_lens, cache, slot,
                                          block_row, ctx_ids, emit)

    def _ring_cut(self, seq_cache: kvc.KVCache) -> kvc.KVCache:
        """This rank's slots of a prefill's dense cache when the KV ring
        splits over "model" (rank r: slots [r C/m, (r+1) C/m) of every KV
        leaf, wrap included: the prefill's cache is already the ring)."""
        if self._ring_split == 1:
            return seq_cache
        r, m = self._share.tp_rank, self._ring_split
        kv = []
        for layer in seq_cache.kv:
            if "k_pos" in layer:
                c = layer["k_pos"].shape[1] // m
                layer = {n: t.narrow(1, r * c, c) for n, t in layer.items()}
            kv.append(layer)
        return kvc.KVCache(kv, enc_out=seq_cache.enc_out)

    def _prefill_insert_local(self, tokens, true_lens, cache, slot,
                              block_row, ctx_ids, emit):
        if not self.paged:
            if ctx_ids is not None:
                raise ValueError("prefix context is gathered from a paged "
                                 "cache; this executor is dense")
            first, seq_cache = self.prefill(tokens, true_lens)
            return first, self.model.insert_cache(
                cache, self._ring_cut(seq_cache), slot)
        row = self._t(block_row, torch.int64)
        pos0, ctx_kv = 0, None
        if ctx_ids is not None and len(ctx_ids):
            ids = self._t(ctx_ids, torch.int64)
            pos0 = ids.shape[0] * self.block_size
            # the gather copies the context out of the pools (advanced
            # indexing), and the insert below is queued after it on the
            # same stream, so the insert cannot overwrite what it reads
            ctx_kv = self.model.gather_prefix_ctx(cache, ids)
            row = row[ids.shape[0]:]
        first, seq_cache = self.prefill(tokens, true_lens, pos0=pos0,
                                        ctx_kv=ctx_kv, emit=emit)
        cache = self.model.insert_cache(cache, seq_cache, slot, row)
        return first, cache

    @torch.inference_mode()
    def copy_blocks(self, cache, moves):
        """Copy pool blocks from shard to shard, exactly, on a mesh whose
        pool splits over the slot axes: ``moves`` are (source, destination)
        global block ids, the same list on every rank (every rank calls
        this at the same point of the serve loop).  Each source shard's
        blocks (every layer's leaves, as raw bytes) are broadcast once over
        the slot group at each model coordinate; the ranks of a
        destination's shard write them into their own blocks.  Returns the
        cache; ``blocks_copied`` counts the blocks."""
        self._check_pool(cache)
        share = self._share
        if share is None or self.n_block_shards == 1:
            raise ValueError("copy_blocks moves blocks between the shards "
                             "of a split pool")
        by_src = {}
        for src, dst in moves:
            by_src.setdefault(int(self.block_shards[src]), []).append(
                (int(src), int(dst)))
        leaves = [t for layer in cache.kv for _, t in sorted(layer.items())]
        for shard in sorted(by_src):
            pairs = by_src[shard]
            n = len(pairs)
            sizes = [n * t[0].numel() * t.element_size() for t in leaves]
            if share.shard == shard:
                ids = self._t(share.local_block_ids([a for a, _ in pairs]),
                              torch.int64)
                buf = torch.cat([t[ids].reshape(-1).view(torch.uint8)
                                 for t in leaves])
            else:
                buf = torch.empty((sum(sizes),), dtype=torch.uint8,
                                  device=self.device)
            share.broadcast_from_shard(buf, shard)
            mine = [b for _, b in pairs
                    if int(self.block_shards[b]) == share.shard]
            if mine:
                if len(mine) != n:
                    raise ValueError("one source shard's moves must all go "
                                     "to one destination shard")
                ids = self._t(share.local_block_ids(mine), torch.int64)
                for t, part in zip(leaves, torch.split(buf, sizes)):
                    t[ids] = part.view(t.dtype).reshape(n, *t.shape[1:])
            self.blocks_copied += n
        return cache

    @torch.inference_mode()
    def insert_burst(self, cache, seq_cache, slots, valid, block_rows=None):
        """Insert row i of a burst's prefill cache into slot ``slots[i]``
        for every i with ``valid[i]``: the slot's row of the slab (dense),
        or the blocks of ``block_rows[i]`` (paged; -1 entries, the burst's
        padding past a row's own blocks, go to the slot's scratch
        block)."""
        self._check_pool(cache)
        if self.paged and block_rows is None:
            raise ValueError("a paged burst insert needs block_rows")
        share = self._share
        for i, (slot, ok) in enumerate(zip(np.asarray(slots),
                                           np.asarray(valid))):
            if not ok:
                continue
            if share is not None:
                # ``seq_cache`` holds this rank's rows of the burst only
                slot = int(slot) - share.row0
            row = self._ring_cut(self.model.slice_cache(seq_cache, i))
            brow = None
            if self.paged:
                brow = (block_rows[i] if share is None
                        else share.local_block_ids(block_rows[i]))
                brow = self._t(brow, torch.int64)
            cache = self.model.insert_cache(cache, row, int(slot), brow)
        return cache

    @torch.inference_mode()
    def prefill_burst(self, tokens, true_lens, slots, cache, row_lens=None,
                      block_rows=None):
        """A burst admission: one prefill forward over ``tokens`` (Bb, Sb)
        and the insert of row i into slot ``slots[i]`` (paged: into the
        blocks of ``block_rows[i]``).  Returns (first greedy tokens (Bb,)
        ndarray, cache).  On a mesh each rank prefills only the rows of its
        own slots (none: no forward), and the first tokens are gathered."""
        share = self._share
        if share is None:
            first, seq_cache = self.prefill(tokens, true_lens,
                                            row_lens=row_lens)
            first = first.cpu().numpy()
            cache = self.insert_burst(cache, seq_cache, slots,
                                      np.ones(len(slots), bool),
                                      block_rows=block_rows)
            return first, cache
        self._check_pool(cache)
        mine = [i for i, s in enumerate(slots) if share.owns(s)]
        vec = torch.zeros((self.local_batch,), dtype=torch.int32,
                          device=self.device)
        if mine:
            idx = np.asarray(mine)
            first, seq_cache = self.prefill(
                np.asarray(tokens)[idx], np.asarray(true_lens)[idx],
                row_lens=(None if row_lens is None
                          else [row_lens[i] for i in mine]))
            loc = [int(slots[i]) for i in mine]
            cache = self.insert_burst(
                cache, seq_cache, loc, np.ones(len(mine), bool),
                block_rows=(None if block_rows is None
                            else np.asarray(block_rows)[idx]))
            vec[torch.as_tensor([s - share.row0 for s in loc],
                                device=self.device)] = first
        got = share.gather(vec).cpu().numpy()
        return got[np.asarray(slots)], cache

    @torch.inference_mode()
    def decode(self, token, pos, active, cache, block_table=None):
        """One masked decode step over all slots -> (greedy next token (B,)
        int32 tensor, cache updated in place).  ``cache`` is the executor's
        own; ``block_table`` the slots' table (paged) or None (dense).  On
        a CUDA device the step is a graph replay."""
        self._check_pool(cache)
        self._put(token, pos, active, 0)
        self._table(block_table)
        self._run("decode", self._decode_body)
        if self._share is not None:
            return self._share.gather(self._next), cache
        return self._next.clone(), cache

    @torch.inference_mode()
    def decode_multi(self, token, pos, active, remaining, cache,
                     block_table=None, eos_id: int = -1):
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
        self._rows = None                 # the round moved the rows on
        toks = (self._toks if self._share is None
                else self._share.gather(self._toks, dim=1))
        return RoundTokens(toks), self.carry, cache

    def _need_spec(self) -> None:
        if self.speculative is None:
            raise ValueError("draft / verify need speculative=(bits, k) at "
                             "construction")

    @torch.inference_mode()
    def draft(self, token, pos, active, cache, block_table):
        """One k-step draft pass with the draft params; the inputs as for
        :meth:`decode`.  Returns (:class:`RoundTokens` of the (B, k)
        drafts, cache).  Pass the drafts on to :meth:`verify` as they are:
        the verify reads them from the device buffer."""
        self._need_spec()
        self._check_pool(cache)
        self._put(token, pos, active, 0)
        self._table(block_table)
        self._run("draft", self._draft_body)
        if self._share is not None:
            self._drafts_out = self._share.gather(self._drafts)
            return RoundTokens(self._drafts_out), cache
        return RoundTokens(self._drafts), cache

    @torch.inference_mode()
    def verify(self, token, drafts, pos0, active, cache, block_table):
        """One k-token verify at the target width.  ``token`` (B, 1) is the
        round's feed token, ``pos0`` (B, 1) its position, ``drafts`` what
        the last :meth:`draft` returned (its buffer: nothing to upload) or
        (B, k) tokens of the caller's (uploaded into that buffer).  Returns
        (:class:`RoundTokens` of the (B, k) verdicts, cache): verdict j is
        the target's greedy token after ``[token, drafts[:, :j]]``."""
        self._need_spec()
        self._check_pool(cache)
        share = self._share
        if not (isinstance(drafts, RoundTokens)
                and drafts.source is (self._drafts if share is None
                                      else self._drafts_out)):
            if not isinstance(drafts, torch.Tensor):
                drafts = torch.from_numpy(np.asarray(drafts, np.int32))
            if share is not None:
                drafts = drafts[share.row0:share.row0 + self.local_batch]
            self._drafts.copy_(drafts.reshape(self._drafts.shape))
        self._put(token, pos0, active, 0)
        self._table(block_table)
        self._run("verify", self._verify_body)
        if share is not None:
            return RoundTokens(share.gather(self._verdicts)), cache
        return RoundTokens(self._verdicts), cache
