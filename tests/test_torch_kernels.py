"""The port's kernel modules against the JAX package: the plain versions
of the three kernels against the JAX oracles and the Pallas kernels in
interpret mode, the traffic model, and the device routing.  The CUDA
kernels themselves are held against these plain versions by
``tests/test_torch_cuda.py`` on a card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import psi as jpsi
from repro.kernels import paged_attention as jpa
from repro.kernels import psi_matmul as jpk
from repro.kernels import ref as jref
from repro_torch.core import psi as tpsi
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import psi_matmul as tpm
from repro_torch.kernels import ref as tref

torch.set_num_threads(1)

# f32 sums in another order: ~K * 2^-24 relative on outputs of size ~sqrt(K)
F32 = dict(rtol=1e-5, atol=1e-5)
RAGGED = [(1, 64, 32), (3, 40, 36), (7, 72, 100), (16, 64, 256)]


def _qt(seed, K, N, bits, packed):
    w = np.random.default_rng(seed).normal(size=(K, N)).astype(np.float32)
    q = jpsi.quantize_weights(jnp.asarray(w), bits, axis=(0,))
    return q.pack() if packed else q


@pytest.mark.parametrize("M,K,N", RAGGED)
def test_codes_ref_matches_jax_oracle_and_interpret(M, K, N):
    x = np.random.default_rng(M).normal(size=(M, K)).astype(np.float32)
    q = _qt(K + N, K, N, 8, False)
    scale = np.array(q.scale).reshape(-1)
    got = tref.psi_matmul_codes_ref(torch.from_numpy(x),
                                    torch.from_numpy(np.array(q.data)),
                                    torch.from_numpy(scale)).numpy()
    oracle = np.asarray(jref.psi_matmul_codes_ref(jnp.asarray(x), q.data,
                                                  jnp.asarray(scale)))
    interp = np.asarray(jpk.psi_matmul_int8(jnp.asarray(x), q.data,
                                            jnp.asarray(scale),
                                            interpret=True))
    np.testing.assert_allclose(got, oracle, **F32)
    np.testing.assert_allclose(got, interp, **F32)


@pytest.mark.parametrize("bits", [2, 3, 5, 7])
@pytest.mark.parametrize("M,K,N", RAGGED[1:3])
def test_packed_ref_matches_jax_oracle_and_interpret(bits, M, K, N):
    x = np.random.default_rng(bits).normal(size=(M, K)).astype(np.float32)
    q = _qt(bits * 7 + K, K, N, bits, True)
    scale = np.array(q.scale).reshape(-1)
    got = tref.psi_matmul_packed_ref(torch.from_numpy(x),
                                     torch.from_numpy(np.array(q.data)),
                                     torch.from_numpy(scale), bits).numpy()
    oracle = np.asarray(jref.psi_matmul_packed_ref(
        jnp.asarray(x), q.data, jnp.asarray(scale), bits))
    interp = np.asarray(jpk.psi_matmul_packed(
        jnp.asarray(x), q.data, jnp.asarray(scale), bits=bits,
        interpret=True))
    np.testing.assert_allclose(got, oracle, **F32)
    np.testing.assert_allclose(got, interp, **F32)


# ---------------------------------------------------------------------------
# Paged attention: fuzzed tables (holes, -1 rows, permuted blocks, stale
# garbage, boundary positions), as tests/test_paged_attention.py builds them.
# ---------------------------------------------------------------------------
BS, HQ, HKV, HD = 4, 8, 2, 16


def _case(seed, B, n_bt, mode, bs=BS, hq=HQ, hkv=HKV, hd=HD):
    rng = np.random.default_rng(seed)
    N = B * n_bt + B
    q = rng.normal(size=(B, hq, hd)).astype(np.float32)
    if mode == "int8":
        kp = rng.integers(-127, 128, size=(N, bs, hkv, hd)).astype(np.int8)
        vp = rng.integers(-127, 128, size=(N, bs, hkv, hd)).astype(np.int8)
        ks = rng.uniform(1e-3, 0.05, size=(N, bs, hkv, 1)).astype(np.float32)
        vs = rng.uniform(1e-3, 0.05, size=(N, bs, hkv, 1)).astype(np.float32)
    else:
        kp = rng.normal(size=(N, bs, hkv, hd)).astype(np.float32)
        vp = rng.normal(size=(N, bs, hkv, hd)).astype(np.float32)
        ks = vs = None
    bt = rng.permutation(B * n_bt).astype(np.int32).reshape(B, n_bt)
    bt = np.where(rng.random((B, n_bt)) < 0.3, -1, bt).astype(np.int32)
    if B > 1:
        bt[rng.integers(B)] = -1
    bounds = np.array([0, bs - 1, bs, n_bt * bs - 1])
    pos = np.where(rng.random(B) < 0.5, rng.choice(bounds, size=B),
                   rng.integers(0, n_bt * bs, size=B)).astype(np.int32)
    return q, kp, vp, bt, pos, ks, vs


def _visible_rows(bt, pos, bs=BS):
    j = np.arange(bt.shape[1]) * bs
    return ((bt >= 0) & (j[None, :] <= pos[:, None])).any(axis=1)


def _torch_args(case, device="cpu", act=torch.float32):
    q, kp, vp, bt, pos, ks, vs = case
    t = lambda a: None if a is None else torch.from_numpy(a).to(device)
    qt = t(q).to(act)
    kt, vt = t(kp), t(vp)
    if ks is None:
        kt, vt = kt.to(act), vt.to(act)
    return qt, kt, vt, t(bt), t(pos), t(ks), t(vs)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("mode", ["f32", "int8"])
@pytest.mark.parametrize("B,n_bt", [(1, 2), (3, 3), (4, 6), (2, 40)])
def test_paged_attention_ref_matches_jax(seed, mode, B, n_bt):
    """The plain version against the JAX oracle; at the long table (40
    entries, long enough for the CUDA kernel to split it) also against the
    Pallas kernel in interpret mode, which returns exact zeros on rows with
    no visible key."""
    case = _case(seed * 31 + B, B, n_bt, mode)
    q, kp, vp, bt, pos, ks, vs = case
    jargs = [jnp.asarray(a) for a in (q, kp, vp, bt, pos)] + [
        None if a is None else jnp.asarray(a) for a in (ks, vs)]
    want = np.asarray(jpa.paged_attention_ref(*jargs))
    got = tpa.paged_attention_ref(*_torch_args(case)).numpy()
    rows = _visible_rows(bt, pos)
    np.testing.assert_allclose(got[rows], want[rows], **F32)
    if n_bt >= 40:
        interp = np.asarray(jpa.paged_attention_pallas(*jargs,
                                                       interpret=True))
        np.testing.assert_allclose(got[rows], interp[rows], **F32)
        assert (interp[~rows] == 0).all()


def test_synth_positions_match():
    bt = np.array([[2, -1, 0], [-1, -1, -1]], np.int32)
    np.testing.assert_array_equal(
        np.asarray(jpa.synth_positions(jnp.asarray(bt), 4)),
        tpa.synth_positions(torch.from_numpy(bt), 4).numpy())


@pytest.mark.parametrize("quantized", [False, True])
def test_traffic_model_matches(quantized):
    for args in [(4, 32, 16, 8, 128), (1, 3, 4, 2, 16)]:
        assert (jpa.gathered_bytes(*args, quantized=quantized)
                == tpa.gathered_bytes(*args, quantized=quantized))
    for args in [(128, 16, 8, 128), (5, 4, 2, 16)]:
        assert (jpa.streamed_bytes(*args, quantized=quantized)
                == tpa.streamed_bytes(*args, quantized=quantized))


@pytest.mark.parametrize("B,Hkv,G,n_bt", [
    (4, 8, 4, 5), (4, 8, 4, 32), (16, 8, 4, 128), (1, 1, 48, 64),
    (64, 8, 4, 2048), (2, 2, 6, 160), (256, 8, 1, 3)])
def test_split_plan_covers_the_table(B, Hkv, G, n_bt):
    """Every table entry lies in exactly one split of at most MAX_CHUNK
    entries; a table is split only while the grid fits in one wave of one
    block per SM, and each split keeps MIN_SPLIT_ROWS key rows."""
    bs, n_sm = 16, 132
    chunk, n_split = tpa.split_plan(B, Hkv, G, n_bt, bs, n_sm)
    assert 1 <= chunk <= tpa.MAX_CHUNK
    assert (n_split - 1) * chunk < n_bt <= n_split * chunk
    blocks = B * Hkv * tpa.head_groups(G)
    if n_split > 1 and chunk < tpa.MAX_CHUNK:
        assert chunk * bs >= tpa.MIN_SPLIT_ROWS
        assert blocks * n_split <= n_sm
    if blocks >= n_sm:
        assert n_split == -(-n_bt // tpa.MAX_CHUNK)


@pytest.mark.parametrize("G,groups", [(1, 1), (2, 1), (4, 1), (6, 1),
                                      (8, 1), (16, 2), (48, 6)])
def test_head_groups(G, groups):
    per = tpa.heads_per_block(G)
    assert per in (1, 2, 4, 8)
    assert tpa.head_groups(G) == groups == -(-G // per)


# ---------------------------------------------------------------------------
# Kernel 2's tensor-core route: the host-side tile and split-K plan.
# ---------------------------------------------------------------------------
def _weight_shapes():
    """(K, N) of every PSI-quantized matmul of the registered configs."""
    from repro_torch.configs.base import _REGISTRY
    shapes = set()
    for cfg in _REGISTRY.values():
        d, hd = cfg.d_model, cfg.resolved_head_dim
        shapes |= {(d, cfg.n_heads * hd), (d, cfg.n_kv_heads * hd),
                   (cfg.n_heads * hd, d), (d, cfg.d_ff), (cfg.d_ff, d),
                   (d, cfg.vocab_size)}
    return sorted(shapes)


PLAN_SHAPES = _weight_shapes() + [(8, 5), (40, 37), (64, 33), (72, 100),
                                  (1032, 1000), (4104, 4100), (520, 151937)]


def _check_plan(chunk, n_split, K, N, blocks, group_k, tile_n):
    """The blocks of a bf16 route (channel tiles of tile_n x splits of
    chunk groups of group_k K rows, warps taking a split's groups in turn)
    cover every K row and every N column exactly once, every split has
    work, a tile's splits fit one cluster (MAX_SPLIT blocks), and no split
    leaves a warp of a block idle because of the plan (a block has WARPS
    warps) or adds blocks past ``blocks``."""
    groups = -(-K // group_k)
    assert 1 <= chunk <= groups and n_split == -(-groups // chunk)
    assert n_split <= tpm.MAX_SPLIT
    k_hits = np.zeros(K, np.int64)
    for s in range(n_split):
        mine = range(s * chunk, min(groups, (s + 1) * chunk))
        assert len(mine) >= 1
        for w in range(tpm.WARPS):
            for grp in mine[w::tpm.WARPS]:
                k_hits[grp * group_k:(grp + 1) * group_k] += 1
    assert (k_hits == 1).all()
    n_hits = np.zeros(N, np.int64)
    for tile in range(-(-N // tile_n)):
        n_hits[tile * tile_n:(tile + 1) * tile_n] += 1
    assert (n_hits == 1).all()
    if n_split > 1:
        assert chunk >= tpm.WARPS or groups < 2 * tpm.WARPS
        assert -(-N // tile_n) * (n_split - 1) < blocks


@pytest.mark.parametrize("n_sm", [132, 114, 1])
@pytest.mark.parametrize("K,N", PLAN_SHAPES)
def test_packed_split_plan_covers_every_row_and_column(K, N, n_sm):
    """The packed route's plan (plane rows are 8 K rows, so K % 8 ==
    0) covers its weight as :func:`_check_plan` says, at one block per
    SM."""
    chunk, n_split = tpm.split_plan(K, N, n_sm)
    _check_plan(chunk, n_split, K, N, n_sm, tpm.GROUP_K, tpm.TILE_N)


# codes take any K: ragged ones beside every weight shape of the configs
CODES_PLAN_SHAPES = PLAN_SHAPES + [(1, 4), (37, 33), (100, 36), (4097, 1024),
                                   (12289, 4096), (4095, 151936)]


@pytest.mark.parametrize("n_sm", [132, 114, 1])
@pytest.mark.parametrize("K,N", CODES_PLAN_SHAPES)
def test_codes_split_plan_covers_every_row_and_column(K, N, n_sm):
    """The codes route's plan (64- or 128-channel tiles, 16-K steps) covers
    every K row (the last step may be partial, K need not be a multiple of
    8 or 64) and every N column exactly once, at CODES_BLOCKS_PER_SM blocks
    per SM."""
    tile, chunk, n_split = tpm.codes_split_plan(K, N, n_sm)
    assert tile in tpm.CODES_TILES
    _check_plan(chunk, n_split, K, N, tpm.CODES_BLOCKS_PER_SM * n_sm,
                tpm.CODES_STEP_K, tile)


def test_codes_split_plan_depends_on_the_weight_only():
    """The codes plan takes K, N and the SM count, never M: a row's sums
    run in the same order whatever the batch it is launched in."""
    import inspect
    assert list(inspect.signature(tpm.codes_split_plan).parameters) == [
        "K", "N", "n_sm"]


def test_packed_split_plan_depends_on_the_weight_only():
    """The plan takes K, N and the SM count, never M: a row's sums run in
    the same order whatever the batch it is launched in."""
    import inspect
    assert list(inspect.signature(tpm.split_plan).parameters) == [
        "K", "N", "n_sm"]
    assert tpm.split_plan(4096, 1024) == (13, 5)
    assert tpm.split_plan(4096, 151936) == (64, 1)


# ---------------------------------------------------------------------------
# Routing: by device only.
# ---------------------------------------------------------------------------
def test_cpu_tensors_take_the_plain_versions():
    ops.reset_launch_counts()
    q = tpsi.quantize_weights(torch.randn(16, 8), 8, axis=(0,))
    x = torch.randn(3, 16)
    torch.testing.assert_close(
        ops.psi_matmul(x, q), tref.psi_matmul_codes_ref(x, q.data, q.scale),
        rtol=0, atol=0)
    case = _torch_args(_case(1, 2, 3, "f32"))
    torch.testing.assert_close(ops.paged_decode_attention(*case),
                               tpa.paged_attention_ref(*case), rtol=0, atol=0)
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}


def test_cuda_wrappers_refuse_cpu_tensors():
    q = tpsi.quantize_weights(torch.randn(16, 8), 8, axis=(0,))
    with pytest.raises(ValueError, match="CUDA"):
        tpm.psi_matmul_codes_cuda(torch.randn(2, 16), q.data,
                                  q.scale.reshape(-1))
    q5 = tpsi.quantize_weights(torch.randn(16, 8), 5, axis=(0,)).pack()
    for dtype in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match="CUDA"):
            tpm.psi_matmul_packed_cuda(torch.randn(2, 16).to(dtype), q5.data,
                                       q5.scale.reshape(-1), 5)
    with pytest.raises(ValueError, match="CUDA"):
        tpa.paged_attention_cuda(*_torch_args(_case(1, 2, 3, "f32")))
