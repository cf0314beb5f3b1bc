"""The port's CUDA kernels and serving path on a card, against the plain
PyTorch versions on the same inputs.  No JAX here, so the file runs on a
machine with a card and PyTorch only:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Every test skips when no CUDA device is present.
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.core import psi
from repro_torch.kernels import _build, ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ref
from repro_torch.launch import scheduler, serve
from repro_torch.models import build_model

torch.set_num_threads(1)

SHAPES = [(1, 64, 32), (3, 40, 36), (5, 40, 37), (2, 64, 33),
          (7, 72, 100), (16, 64, 256), (4, 4096, 1024)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only on the H100")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [8, 2, 5, 7])
@pytest.mark.parametrize("M,K,N", SHAPES)
def test_psi_matmul_matches_plain(cuda, dtype, bits, M, K, N):
    g = torch.Generator().manual_seed(M * N + bits)
    q = psi.quantize_weights(torch.randn(K, N, generator=g), bits,
                             axis=(0,))
    if bits < 8:
        q = q.pack()
    x = torch.randn(M, K, generator=g).to(dtype)
    want = ops.psi_matmul(x, q).float()
    before = ops.launch_counts()
    got = ops.psi_matmul(x.to(cuda), q.to(cuda)).float().cpu()
    key = "psi_matmul_codes" if bits == 8 else "psi_matmul_packed"
    assert ops.launch_counts()[key] == before[key] + 1
    # f32: the K-term sums differ in order, an error that grows with K and
    # the terms' size, not with each output's size: 1e-5 of the largest
    # output.  bf16: one rounding of the f32 sum, ~1 ulp of the output.
    if dtype == torch.float32:
        tol = dict(rtol=1e-5, atol=1e-5 * max(1.0, float(want.abs().max())))
    else:
        tol = dict(rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(got, want, **tol)


def _case(seed, B, n_bt, mode, hq, hkv, hd, bs):
    """Pools of garbage; permuted tables with holes, an inactive slot and
    boundary positions {0, bs-1, bs, n_bt*bs-1}."""
    rng = np.random.default_rng(seed)
    N = B * n_bt + B
    q = torch.from_numpy(rng.normal(size=(B, hq, hd)).astype(np.float32))
    if mode == "int8":
        kp, vp = (torch.from_numpy(rng.integers(
            -127, 128, size=(N, bs, hkv, hd)).astype(np.int8))
            for _ in range(2))
        ks, vs = (torch.from_numpy(rng.uniform(
            1e-3, 0.05, size=(N, bs, hkv, 1)).astype(np.float32))
            for _ in range(2))
    else:
        kp, vp = (torch.from_numpy(rng.normal(
            size=(N, bs, hkv, hd)).astype(np.float32)) for _ in range(2))
        ks = vs = None
    bt = rng.permutation(B * n_bt).astype(np.int32).reshape(B, n_bt)
    bt = np.where(rng.random((B, n_bt)) < 0.3, -1, bt).astype(np.int32)
    bt[rng.integers(B)] = -1
    pos = np.array([0, bs - 1, bs, n_bt * bs - 1] * B, np.int32)[:B]
    return q, kp, vp, torch.from_numpy(bt), torch.from_numpy(pos), ks, vs


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("mode", ["f32", "int8"])
@pytest.mark.parametrize("shape", [(4, 2, 16, 16), (32, 8, 128, 16)])
def test_paged_attention_matches_plain(cuda, seed, mode, shape):
    hq, hkv, hd, bs = shape
    case = _case(seed, 4, 5, mode, hq, hkv, hd, bs)
    want = pa.paged_attention_ref(*case)
    got = ops.paged_decode_attention(
        *(None if t is None else t.to(cuda) for t in case)).cpu()
    bt, pos = case[3], case[4]
    j = torch.arange(bt.shape[1]) * bs
    rows = ((bt >= 0) & (j[None] <= pos[:, None])).any(dim=1)
    torch.testing.assert_close(got[rows], want[rows], rtol=1e-4, atol=1e-4)
    assert bool((got[~rows] == 0).all())


# ---------------------------------------------------------------------------
# The split path: tables long enough that the kernel splits them across
# blocks, with positions on and around the split boundaries.
# ---------------------------------------------------------------------------
MODES = {"bf16": (torch.bfloat16, False), "bf16-int8": (torch.bfloat16, True),
         "f32": (torch.float32, False), "f32-int8": (torch.float32, True)}
GD = [(g, d) for g in (1, 2, 4, 6, 8, 16, 48) for d in (16, 64, 128, 256)]


def _split_case(seed, n_bt, G, Hkv, D, mode, dev, bs=16, q_mul=1.0):
    """Six slots: pos on the first split boundary, one short of it, inside
    the first split only, an all -1 slot, a slot whose only visible keys lie
    in its last split, and a full one; 30 % holes elsewhere.  ``q_mul``
    scales q (a power of two keeps bf16 q exact): at 4 the scores spread
    over a few units and a few keys carry each row."""
    B = 6
    chunk, n_split = pa.split_plan(B, Hkv, G, n_bt, bs, _build.sm_count(0))
    assert n_split > 1
    rng = np.random.default_rng(seed)
    act, quant = MODES[mode]
    N = B * n_bt + B
    q = torch.from_numpy(rng.normal(size=(B, G * Hkv, D)).astype(np.float32))
    q = q * q_mul
    if quant:
        kp, vp = (torch.from_numpy(rng.integers(
            -127, 128, size=(N, bs, Hkv, D)).astype(np.int8))
            for _ in range(2))
        ks, vs = (torch.from_numpy(rng.uniform(
            1e-3, 0.05, size=(N, bs, Hkv, 1)).astype(np.float32)).to(dev)
            for _ in range(2))
    else:
        kp, vp = (torch.from_numpy(rng.normal(
            size=(N, bs, Hkv, D)).astype(np.float32)).to(act)
            for _ in range(2))
        ks = vs = None
    bt = rng.permutation(B * n_bt).astype(np.int32).reshape(B, n_bt)
    bt = np.where(rng.random((B, n_bt)) < 0.3, -1, bt).astype(np.int32)
    bt[:, 0] = np.abs(bt[:, 0])             # the first entry always present
    bt[3] = -1
    bt[4, :(n_split - 1) * chunk] = -1
    bt[4, -1] = B * n_bt + 4
    pos = np.array([chunk * bs, chunk * bs - 1, bs + 3, n_bt * bs - 1,
                    n_bt * bs - 1, n_bt * bs - 1], np.int32)
    return (q.to(act).to(dev), kp.to(dev), vp.to(dev),
            torch.from_numpy(bt).to(dev), torch.from_numpy(pos).to(dev),
            ks, vs)


def _check_split(case, bs=16):
    """The kernel against the plain version under chip_smoke.py's
    per-element tolerances; rows with no visible key are exact zeros."""
    q, kp, vp, bt, pos, ks, vs = case
    before = ops.launch_counts()["paged_attention"]
    got = ops.paged_decode_attention(*case)
    assert ops.launch_counts()["paged_attention"] == before + 1
    want = pa.paged_attention_ref(*case)
    j = torch.arange(bt.shape[1], device=bt.device) * bs
    rows = ((bt >= 0) & (j[None] <= pos[:, None])).any(dim=1)
    assert bool((got[~rows] == 0).all())
    want = want[rows].float()
    a = pa.paged_attention_ref(q, kp, vp.abs(), bt, pos, ks, vs)[rows].float()
    tol = (2.0 ** -7 * want.abs() + 2.0 ** -5 * a
           if q.dtype == torch.bfloat16 else 1e-5 * (want.abs() + a))
    d = (got[rows].float() - want).abs()
    assert bool(torch.isfinite(got).all())
    assert bool((d <= tol).all()), float((d - tol).max())


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("n_bt", [64, 160])
def test_paged_attention_split_boundaries(cuda, seed, mode, n_bt):
    _check_split(_split_case(seed, n_bt, 4, 8, 128, mode, cuda))


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("G,D", GD)
def test_paged_attention_split_every_group_and_width(cuda, mode, G, D):
    _check_split(_split_case(G * 1000 + D, 64, G, 1 if G == 48 else 2, D,
                             mode, cuda))


TIGHT = [(g, d, 1 if g == 48 else 2, 64) for g, d in GD] + [(4, 128, 8, 160)]


@pytest.mark.parametrize("q_mul", [1.0, 4.0])
@pytest.mark.parametrize("G,D,Hkv,n_bt", TIGHT)
def test_paged_attention_bf16_tight(cuda, q_mul, G, D, Hkv, n_bt):
    """bf16 q and pool (the tensor-core path at D 64 and 128) against the
    plain version run in f32 on the same bf16 values.  The kernel rounds
    twice: p to bf16 before P.V (at most 2^-8 of each term, so 2^-8 A) and
    the output to bf16 (2^-8 |want|); its dots, exps and sums are f32.  The
    check allows twice that, 2^-7 (|want| + A): a few per cent off in p, as
    from a wrong score scale, shows at q_mul 4, where a few keys carry each
    row and |want| is of the size of A."""
    case = _split_case(G * 1000 + D + 7, n_bt, G, Hkv, D, "bf16", cuda,
                       q_mul=q_mul)
    q, kp, vp, bt, pos, _, _ = case
    got = ops.paged_decode_attention(*case).float()
    q32, k32, v32 = (t.float() for t in (q, kp, vp))
    want = pa.paged_attention_ref(q32, k32, v32, bt, pos)
    a = pa.paged_attention_ref(q32, k32, v32.abs(), bt, pos)
    j = torch.arange(bt.shape[1], device=bt.device) * 16
    rows = ((bt >= 0) & (j[None] <= pos[:, None])).any(dim=1)
    assert bool((got[~rows] == 0).all())
    d = (got - want)[rows].abs()
    tol = 2.0 ** -7 * (want[rows].abs() + a[rows])
    assert bool((d <= tol).all()), float((d - tol).max())


def test_serving_on_the_card_matches_the_cpu(cuda):
    """Reduced qwen3-8b psi8 (float32): the same params and trace give the
    same greedy tokens on the card and on the CPU, through kernels 1 and 3
    at 7 * n_layers + 1 matmuls and n_layers attention reads per step."""
    cfg = reduced_config(get_config("qwen3-8b"), quant_mode="psi8")
    params = build_model(cfg).init(seed=0, device="cpu", bits=8)
    trace = lambda: scheduler.poisson_trace(
        4, rate_rps=1e9, prompt_len=12, max_new=8, vocab_size=256, seed=3,
        prompt_jitter=4)
    done = {}
    for dev in ("cpu", "cuda"):
        server = serve.Server(cfg, params, max_batch=2, max_seq=64,
                              device=dev)
        server.warmup(trace())
        ops.reset_launch_counts()
        reqs, stats = server.serve(trace(), warmup=False)
        done[dev] = {r.rid: r.tokens for r in reqs}
        counts = ops.launch_counts()
    per = 7 * cfg.n_layers + 1
    assert done["cuda"] == done["cpu"]
    assert counts == {
        "psi_matmul_codes": per * (stats["decode_steps"]
                                   + stats["prefill_forwards"]),
        "psi_matmul_packed": 0,
        "paged_attention": cfg.n_layers * stats["decode_steps"]}


# ---------------------------------------------------------------------------
# The tensor-core routes of kernels 1 and 2 (bf16 x): tight against the plain
# version in f32, at every qwen3-8b weight shape and ragged ones, and batch
# invariant.
# ---------------------------------------------------------------------------
QWEN_KN = [(4096, 4096), (4096, 1024), (4096, 12288), (12288, 4096),
           (4096, 151936)]
RAGGED_KN = [(40, 36), (40, 37), (64, 33), (72, 100), (8, 5), (1032, 1000)]
# codes take any K: K % 8 != 0, K % 64 != 0, N % 4 != 0
CODES_RAGGED_KN = [(40, 37), (72, 100), (1032, 1000), (37, 33), (100, 36),
                   (1, 4)]


@functools.lru_cache(maxsize=4)
def _packed_weight(K, N, bits, misaligned=False):
    """PSI-quantized (K, N) weight on the card: bit-planes for bits < 8,
    int8 codes for bits = 8; ``misaligned`` puts them one byte into a
    larger buffer (a view the word loads cannot take)."""
    g = torch.Generator(device="cuda").manual_seed(K * 7 + N + bits)
    w = torch.randn(K, N, generator=g, device="cuda") * K ** -0.5
    q = psi.quantize_weights(w, bits, axis=(0,))
    if bits < 8:
        q = q.pack()
    data = q.data
    if misaligned:
        buf = torch.empty(data.numel() + 1, dtype=data.dtype, device="cuda")
        buf[1:] = data.reshape(-1)
        data = buf[1:].view(data.shape)
        assert data.data_ptr() % 4
    return data, q.scale.reshape(-1)


def _x(M, K, seed, misaligned=False):
    """bf16 x (M, K) on the card; ``misaligned`` starts it one element into
    a larger buffer (rows the 16-byte x loads cannot take)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(M, K, generator=g, device="cuda").to(torch.bfloat16)
    if misaligned:
        buf = torch.empty(M * K + 1, dtype=torch.bfloat16, device="cuda")
        buf[1:] = x.reshape(-1)
        x = buf[1:].view(M, K)
        assert x.data_ptr() % 16
    return x


def _check_tight(cuda, K, N, bits, M, misaligned=False, x_misaligned=False):
    """The kernel's bf16 output against the plain version run in f32 on the
    same bf16 x: |got - want| <= 2^-8 |want| + A.  Every product is exact
    (integer weights |w| <= 128, codes and PSI weights alike, times bf16
    x), so the two differ by the f32 sums' order and by the kernel's one
    rounding to bf16 (at most 2^-8 of the value).  A = 2^-16 (|x| @ |W|)
    scale: two f32 sums of the same terms in other orders differ by a few
    2^-24 of the sum of |terms| (the tensor cores' own sums too), so 2^-16
    leaves a wide margin, while an offset off by one moves each output by
    scale * sum(x), about sqrt(K) x scale, which is far above A."""
    torch.backends.cuda.matmul.allow_tf32 = False
    data, scale = _packed_weight(K, N, bits, misaligned)
    x = _x(M, K, M * 131 + bits, x_misaligned)
    packed = bits < 8
    key = "psi_matmul_packed" if packed else "psi_matmul_codes"
    before = ops.launch_counts()[key]
    got = ops.psi_matmul_2d(x, psi.QuantizedTensor(
        data, scale, psi.get_format(bits), packed)).float()
    assert ops.launch_counts()[key] == before + 1
    codes = psi.unpack_codes(data, bits) if packed else data
    x32 = x.float()
    want = ref.psi_matmul_codes_ref(x32, codes, scale)
    a = 2.0 ** -16 * ref.psi_matmul_codes_ref(x32.abs(), codes.abs(), scale)
    d = (got - want).abs()
    assert bool(torch.isfinite(got).all())
    tol = 2.0 ** -8 * want.abs() + a
    assert bool((d <= tol).all()), float((d - tol).max())


def _check_batch_invariant(K, N, bits):
    """A row's output depends only on its own x row and W: computed alone,
    in an M = 4 launch and in an M = 16 launch it is the same, bit for bit
    (the K split is planned from K and N only)."""
    data, scale = _packed_weight(K, N, bits)
    qt = psi.QuantizedTensor(data, scale, psi.get_format(bits), bits < 8)
    x = _x(16, K, K + N + bits)
    y16 = ops.psi_matmul_2d(x, qt)
    y4 = ops.psi_matmul_2d(x[:4].contiguous(), qt)
    assert torch.equal(y4, y16[:4])
    for i in range(16):
        assert torch.equal(ops.psi_matmul_2d(x[i:i + 1].contiguous(), qt)[0],
                           y16[i]), i


@pytest.mark.parametrize("M", [1, 4, 16, 64, 72])
@pytest.mark.parametrize("bits", [2, 3, 4, 5, 6, 7])
@pytest.mark.parametrize("K,N", QWEN_KN + RAGGED_KN)
def test_psi_matmul_packed_bf16_tight(cuda, K, N, bits, M):
    _check_tight(cuda, K, N, bits, M)


@pytest.mark.parametrize("M", [1, 4, 16, 72])
@pytest.mark.parametrize("bits", [2, 5, 7])
@pytest.mark.parametrize("K,N", [(4096, 1024), (1032, 1000), (64, 36)])
def test_psi_matmul_packed_bf16_misaligned(cuda, K, N, bits, M):
    _check_tight(cuda, K, N, bits, M, misaligned=True)


@pytest.mark.parametrize("bits", [2, 5, 7])
@pytest.mark.parametrize("K,N", QWEN_KN[:4] + [(1032, 1000), (40, 37)])
def test_psi_matmul_packed_batch_invariant(cuda, K, N, bits):
    _check_batch_invariant(K, N, bits)


@pytest.mark.parametrize("M", [1, 4, 16, 64, 72])
@pytest.mark.parametrize("K,N", QWEN_KN + CODES_RAGGED_KN)
def test_psi_matmul_codes_bf16_tight(cuda, K, N, M):
    _check_tight(cuda, K, N, 8, M)


@pytest.mark.parametrize("M", [1, 4, 16, 72])
@pytest.mark.parametrize("which", ["codes", "x"])
@pytest.mark.parametrize("K,N", [(4096, 1024), (1032, 1000), (37, 33)])
def test_psi_matmul_codes_bf16_misaligned(cuda, K, N, which, M):
    _check_tight(cuda, K, N, 8, M, misaligned=which == "codes",
                 x_misaligned=which == "x")


@pytest.mark.parametrize("K,N", QWEN_KN[:4] + [(1032, 1000), (40, 37),
                                               (37, 33)])
def test_psi_matmul_codes_batch_invariant(cuda, K, N):
    _check_batch_invariant(K, N, 8)


# ---------------------------------------------------------------------------
# The decode step and the horizon-M round as CUDA graphs.
# ---------------------------------------------------------------------------
def _graph_executor(dtype, horizon):
    """A reduced qwen3-8b psi8 executor on the card with two prefilled
    slots and a live block table: (executor, cache, table, inputs)."""
    from repro_torch.runtime import Executor
    cfg = reduced_config(get_config("qwen3-8b"), quant_mode="psi8",
                         dtype=dtype)
    params = build_model(cfg).init(seed=0, device="cuda", bits=8)
    ex = Executor(cfg, params, max_batch=3, max_seq=64, device="cuda",
                  decode_horizon=horizon)
    cache = ex.init_cache()
    bt = ex.make_block_table()
    rng = np.random.default_rng(0)
    for slot in range(2):
        row = np.full((ex.n_bt,), -1, np.int32)
        row[:2] = [2 * slot, 2 * slot + 1]
        prompt = rng.integers(0, cfg.vocab_size, size=(1, 16)).astype(
            np.int32)
        ex.prefill_insert(prompt, np.array([13], np.int32), cache, slot, row)
        bt[slot] = row
    inputs = dict(token=np.array([[5], [7], [0]], np.int32),
                  pos=np.array([[13], [13], [0]], np.int32),
                  active=np.array([True, True, False]),
                  remaining=np.array([20, 3, 0], np.int32))
    return ex, cache, bt, inputs


def _pool_copy(cache):
    from repro_torch.models.kvcache import KVCache
    return KVCache([{k: t.clone() for k, t in layer.items()}
                    for layer in cache.kv], cache.layout, cache.block_size,
                   cache.n_blocks)


def _eager_batch(inputs, bt, with_round=False):
    b = {"token": torch.from_numpy(inputs["token"]).cuda(),
         "pos": torch.from_numpy(inputs["pos"]).cuda(),
         "active": torch.from_numpy(inputs["active"]).cuda(),
         "block_table": torch.from_numpy(bt.host.copy()).cuda()}
    if with_round:
        b["remaining"] = torch.from_numpy(inputs["remaining"]).cuda()
        b["eos_id"] = torch.tensor(-1, dtype=torch.int32, device="cuda")
    return b


def _assert_pools_equal(cache, ref_cache):
    """Every usable block bit for bit.  The per-slot scratch blocks past
    ``n_blocks`` are left out: nothing reads them, and the capture's warm
    run (all rows inactive) wrote into them."""
    for a, b in zip(cache.kv, ref_cache.kv):
        for k in a:
            assert torch.equal(a[k][:cache.n_blocks],
                               b[k][:cache.n_blocks]), k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_graph_replay_equals_eager_step(cuda, dtype):
    """Two replays of the horizon-1 graph against two eager decode_steps on
    a copy of the pool: tokens and pools bit for bit, and the launches
    each replay adds are one step's (7 * n_layers + 1 matmuls, n_layers
    attention reads; 253 / 36 at 36 layers)."""
    ex, cache, bt, inp = _graph_executor(dtype, 1)
    ref_cache = _pool_copy(cache)
    L = ex.model.cfg.n_layers
    for step in range(2):
        with torch.inference_mode():
            logits, _ = ex.model.decode_step(ex.params, _eager_batch(inp, bt),
                                             ref_cache)
        want = torch.argmax(logits, -1).to(torch.int32)
        before = ops.launch_counts()
        got, _ = ex.decode(inp["token"], inp["pos"], inp["active"], cache,
                           bt)
        after = ops.launch_counts()
        assert torch.equal(got, want), step
        if step:                     # the first call also ran the warm step
            assert after["psi_matmul_codes"] - before["psi_matmul_codes"] \
                == 7 * L + 1
            assert after["paged_attention"] - before["paged_attention"] == L
        inp["token"] = got.cpu().numpy()[:, None]
        inp["pos"] = inp["pos"] + 1
    assert ex.graph_counts() == {"decode": 1, "decode_multi": 0}
    _assert_pools_equal(cache, ref_cache)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_round_graph_equals_eager_steps(cuda, dtype):
    """One horizon-4 graph round against 4 eager decode_steps plus the
    retirement recurrence (Model.decode_scan, eagerly) on a copy of the
    pool: tokens, carry and pools bit for bit; slot 1's budget of 3 ends
    inside the round; the carry chains into a second round with no
    upload; the round's launches are 4 steps'."""
    ex, cache, bt, inp = _graph_executor(dtype, 4)
    ref_cache = _pool_copy(cache)
    with torch.inference_mode():
        want, wcarry, _ = ex.model.decode_scan(
            ex.params, _eager_batch(inp, bt, True), ref_cache, 4)
    toks, carry, _ = ex.decode_multi(inp["token"], inp["pos"],
                                     inp["active"], inp["remaining"], cache,
                                     bt)
    np.testing.assert_array_equal(np.asarray(toks), want.cpu().numpy())
    for k in ("token", "pos", "remaining"):
        assert torch.equal(carry[k], wcarry[k].to(torch.int32)), k
    assert carry["active"].tolist() == wcarry["active"].int().tolist() \
        == [1, 0, 0]
    _assert_pools_equal(cache, ref_cache)
    L = ex.model.cfg.n_layers
    before = ops.launch_counts()
    toks2, _, _ = ex.decode_multi(carry["token"], carry["pos"],
                                  carry["active"], carry["remaining"], cache,
                                  bt)
    after = ops.launch_counts()
    assert after["psi_matmul_codes"] - before["psi_matmul_codes"] == \
        4 * (7 * L + 1)
    assert after["paged_attention"] - before["paged_attention"] == 4 * L
    with torch.inference_mode():
        want2, _, _ = ex.model.decode_scan(
            ex.params, dict(wcarry, eos_id=torch.tensor(
                -1, dtype=torch.int32, device="cuda"),
                block_table=torch.from_numpy(bt.host.copy()).cuda()),
            ref_cache, 4)
    np.testing.assert_array_equal(np.asarray(toks2), want2.cpu().numpy())
    assert ex.graph_counts() == {"decode": 0, "decode_multi": 1}


def test_block_table_upload_keeps_its_buffer(cuda):
    ex, cache, bt, _ = _graph_executor("float32", 1)
    ptr = bt.device().data_ptr()
    assert ptr == ex._bt.data_ptr()
    full = bt.stats["full_uploads"]
    for slot in range(3):
        bt[slot, :] = np.arange(ex.n_bt, dtype=np.int32) + slot
    dev = bt.device()
    assert bt.stats["full_uploads"] == full + 1
    assert dev.data_ptr() == ptr
    assert dev.cpu().numpy().tolist() == bt.host.tolist()
    bt[1, 0] = 9                                  # one dirty row of three
    assert bt.device().data_ptr() == ptr and bt.stats["row_updates"] == 1
    assert int(ex._bt[1, 0]) == 9


@pytest.mark.parametrize("horizon", [1, 4])
def test_second_serve_reuses_the_graph(cuda, horizon):
    """Two serves on one Server capture one decode graph between them, and
    give the same tokens as the CPU at the same horizon."""
    cfg = reduced_config(get_config("qwen3-8b"), quant_mode="psi8")
    params = build_model(cfg).init(seed=0, device="cpu", bits=8)
    trace = lambda: scheduler.poisson_trace(
        4, rate_rps=1e9, prompt_len=12, max_new=9, vocab_size=256, seed=3,
        prompt_jitter=4)
    cpu = serve.Server(cfg, params, max_batch=2, max_seq=64, device="cpu",
                       decode_horizon=horizon)
    want = {r.rid: r.tokens for r in cpu.serve(trace())[0]}
    server = serve.Server(cfg, params, max_batch=2, max_seq=64,
                          device="cuda", decode_horizon=horizon)
    pool = server.executor.init_cache()
    graphs = []
    for _ in range(2):
        done, stats = server.serve(trace())
        assert {r.rid: r.tokens for r in done} == want
        assert stats["decode_compiles"] == 1
        graphs.append(dict(server.executor._graphs))
    assert graphs[0].keys() == graphs[1].keys() and all(
        graphs[0][k][0] is graphs[1][k][0] for k in graphs[0])
    assert server.executor.init_cache() is pool
