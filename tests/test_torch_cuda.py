"""The port's CUDA kernels and serving path on a card, against the plain
PyTorch versions on the same inputs.  No JAX here, so the file runs on a
machine with a card and PyTorch only:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Every test skips when no CUDA device is present.
"""
import dataclasses
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


def _matmuls_per_forward(cfg, prefill=False):
    """PSI-matmul launches of one decode step: wq, wk, wv, wo (a rec
    layer's w_in_gate, w_in_rec, rglru_wa, rglru_wx, w_out; a mamba
    layer's in_proj, x_proj, dt_proj_w, out_proj and no MLP; an xattn
    layer's four and its cross attention's four) and the MLP's matrices
    (3 gated, 2 for the GELU MLP; none for MoE experts, which are
    dequantized blocks in a plain batched product) per layer, plus the
    lm-head; a ``prefill`` forward adds whisper's encoder (6 a layer)."""
    from repro_torch.models.transformer import layer_kinds
    mlp = 0 if cfg.family == "moe" else (2 if cfg.act == "gelu" else 3)
    own = {"rec": 5 + mlp, "mamba": 4, "xattn": 8 + mlp}
    enc = 6 * cfg.n_enc_layers if prefill and cfg.family == "encdec" else 0
    return sum(own.get(k, 4 + mlp) for k in layer_kinds(cfg)) + 1 + enc


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N", [(3, 40, 36), (4, 4096, 4096),
                                   (288, 4096, 4096)])
def test_psi_matmul_int5_launches_kernel_2(cuda, dtype, M, K, N):
    """The INT5 entry point on CUDA tensors: one kernel-2 launch, within
    the tolerance of test_psi_matmul_matches_plain of its plain version."""
    g = torch.Generator().manual_seed(M + K + N)
    q = psi.quantize_weights(torch.randn(K, N, generator=g), 5,
                             axis=(0,)).pack()
    x = torch.randn(M, K, generator=g).to(dtype)
    want = ops.psi_matmul_int5(x, q.data, q.scale).float()
    before = ops.launch_counts()["psi_matmul_packed"]
    got = ops.psi_matmul_int5(x.to(cuda), q.data.to(cuda),
                              q.scale.to(cuda)).float().cpu()
    assert ops.launch_counts()["psi_matmul_packed"] == before + 1
    if dtype == torch.float32:
        tol = dict(rtol=1e-5, atol=1e-5 * max(1.0, float(want.abs().max())))
    else:
        tol = dict(rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(got, want, **tol)


def test_psi_arithmetic_on_the_card_equals_the_cpu(cuda):
    """The paper's arithmetic (plain ops) gives the same bits on the card
    as on the CPU: decomposition, SAM over every INT8 x INT8 pair, MOA,
    INT8 activations."""
    w = torch.arange(-128, 128, dtype=torch.int32)
    x = w.to(torch.int8)[None, :]
    g = torch.Generator().manual_seed(0)
    operands = torch.randint(-4096, 4096, (18, 512), generator=g,
                             dtype=torch.int32)
    act = torch.randn(4096, generator=g) * 3.0

    def run(dev):
        signs, exps = psi.psi_decompose_int(w[:, None].to(dev), 8)
        return (signs, exps, psi.psi_reconstruct(signs, exps),
                psi.sam_multiply(x.to(dev), signs, exps),
                psi.moa_sign_extension_sum(operands.to(dev), 13, 14),
                *psi.quantize_activations_int8(act.to(dev)))

    for got, want in zip(run(cuda), run(torch.device("cpu"))):
        assert got.is_cuda and torch.equal(got.cpu(), want)


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
    rows0 = ops.route_launch_counts()
    got = ops.psi_matmul_2d(x, psi.QuantizedTensor(
        data, scale, psi.get_format(bits), packed)).float()
    assert ops.launch_counts()[key] == before + 1
    from repro_torch.kernels import psi_matmul as pm
    rows1 = ops.route_launch_counts()
    assert rows1["psi_matmul_codes_rows"] == rows0["psi_matmul_codes_rows"] + (
        not packed and M > pm.CODES_ROWS_MIN_M)
    assert rows1["psi_matmul_packed_rows"] == (
        rows0["psi_matmul_packed_rows"]
        + (packed and pm.packed_launch_plan(M, K, N, _build.sm_count(0))[1]))
    codes = psi.unpack_codes(data, bits) if packed else data
    x32 = x.float()
    want = ref.psi_matmul_codes_ref(x32, codes, scale)
    a = 2.0 ** -16 * ref.psi_matmul_codes_ref(x32.abs(), codes.abs(), scale)
    d = (got - want).abs()
    assert bool(torch.isfinite(got).all())
    tol = 2.0 ** -8 * want.abs() + a
    assert bool((d <= tol).all()), float((d - tol).max())


def _check_batch_invariant(K, N, bits, Ms=()):
    """A row's output depends only on its own x row and W: computed alone,
    in an M = 4 launch and in an M = 16 launch it is the same, bit for bit
    (the K split is planned from K and N only).  Each M of ``Ms`` (the
    prefill routes of kernels 1 and 2 above CODES_ROWS_MIN_M and
    PACKED_ROWS_MIN_M) is launched too, and every row of it equals that
    row of an M = 4 launch, bit for bit."""
    data, scale = _packed_weight(K, N, bits)
    qt = psi.QuantizedTensor(data, scale, psi.get_format(bits), bits < 8)
    x = _x(16, K, K + N + bits)
    y16 = ops.psi_matmul_2d(x, qt)
    y4 = ops.psi_matmul_2d(x[:4].contiguous(), qt)
    assert torch.equal(y4, y16[:4])
    for i in range(16):
        assert torch.equal(ops.psi_matmul_2d(x[i:i + 1].contiguous(), qt)[0],
                           y16[i]), i
    for M in Ms:
        x = _x(M, K, M + K + N + bits)
        y = ops.psi_matmul_2d(x, qt)
        for i in range(0, M, 4):
            assert torch.equal(ops.psi_matmul_2d(x[i:i + 4].contiguous(), qt),
                               y[i:i + 4]), (M, i)


@pytest.mark.parametrize("M", [1, 4, 16, 64, 72])
@pytest.mark.parametrize("bits", [2, 3, 4, 5, 6, 7])
@pytest.mark.parametrize("K,N", QWEN_KN + RAGGED_KN)
def test_psi_matmul_packed_bf16_tight(cuda, K, N, bits, M):
    _check_tight(cuda, K, N, bits, M)


@pytest.mark.parametrize("M", [1, 4, 16, 72, 288])
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


@pytest.mark.parametrize("M", [1, 4, 16, 72, 288])
@pytest.mark.parametrize("which", ["codes", "x"])
@pytest.mark.parametrize("K,N", [(4096, 1024), (1032, 1000), (37, 33)])
def test_psi_matmul_codes_bf16_misaligned(cuda, K, N, which, M):
    _check_tight(cuda, K, N, 8, M, misaligned=which == "codes",
                 x_misaligned=which == "x")


@pytest.mark.parametrize("K,N", QWEN_KN[:4] + [(1032, 1000), (40, 37),
                                               (37, 33)])
def test_psi_matmul_codes_batch_invariant(cuda, K, N):
    _check_batch_invariant(K, N, 8)


# kernel 1's prefill route (M > CODES_ROWS_MIN_M): a qwen3-8b prompt or
# burst (288, 320 rows), whisper's encoder (1500) and cross K/V (6000 rows
# a decode step) at qwen3-8b's, the ragged and whisper's 512-wide shapes
ROWS_KN = QWEN_KN + CODES_RAGGED_KN + [(512, 512), (512, 2048), (2048, 512)]


@pytest.mark.parametrize("M", [288, 320, 1500])
@pytest.mark.parametrize("K,N", ROWS_KN)
def test_psi_matmul_codes_bf16_tight_prefill_rows(cuda, K, N, M):
    _check_tight(cuda, K, N, 8, M)


@pytest.mark.parametrize("K,N", ROWS_KN)
def test_psi_matmul_codes_prefill_rows_batch_invariant(cuda, K, N):
    _check_batch_invariant(K, N, 8, Ms=(288, 320, 6000))


@pytest.mark.parametrize("K,N", ROWS_KN)
def test_psi_matmul_codes_prefill_rows_f32_out_casts_bit_equal(cuda, K, N):
    """The prefill route's f32 output (a row-parallel partial, cast after
    its all-reduce) at M = 288: its cast to bf16 is the bf16 output bit for
    bit, and its rows are those of an M = 4 f32 launch."""
    data, scale = _packed_weight(K, N, 8)
    qt = psi.QuantizedTensor(data, scale, psi.get_format(8), False)
    x = _x(288, K, K * 3 + N)
    y32 = ops.psi_matmul_2d(x, qt, out_dtype=torch.float32)
    assert y32.dtype == torch.float32
    assert torch.equal(y32.to(torch.bfloat16), ops.psi_matmul_2d(x, qt))
    for i in (0, 140, 284):
        assert torch.equal(ops.psi_matmul_2d(
            x[i:i + 4].contiguous(), qt, out_dtype=torch.float32),
            y32[i:i + 4]), i


@pytest.mark.parametrize("M", [33, 64, 288])
@pytest.mark.parametrize("K,N", QWEN_KN + [(1032, 1000), (37, 33)])
def test_psi_matmul_codes_routes_bit_equal_at_the_same_rows(cuda, K, N, M):
    """At the same M, the prefill route, with its splits in one block or
    in a cluster (at 64-channel tiles; a 128-channel tile's plan has one
    split), and the decode route give the same bits (the wrapper picks the
    route by M alone)."""
    from repro_torch.kernels import psi_matmul as pm
    data, scale = _packed_weight(K, N, 8)
    x = _x(M, K, M * 5 + K)
    tile, chunk, _ = pm.codes_split_plan(K, N, _build.sm_count(0))
    want = pm._codes_launch(x, data, scale, None, tile, chunk, 0)
    for cluster in ((0, 1) if tile == 64 else (0,)):
        assert torch.equal(pm._codes_launch(
            x, data, scale, None, tile, chunk, 1, cluster), want), cluster


# kernel 2's prefill route (M > PACKED_ROWS_MIN_M, N > PACKED_ROWS_MIN_N): a
# qwen3-8b psi5 prompt or burst (288, 320 rows) and 1500 rows, at the
# shapes of ROWS_KN whose K planes can hold (K % 8 == 0) and granite-34b's
# five weights
PACKED_ROWS_KN = [kn for kn in ROWS_KN if kn[0] % 8 == 0] + [
    (6144, 6144), (6144, 128), (6144, 24576), (24576, 6144), (6144, 49152)]


@pytest.mark.parametrize("M", [288, 320, 1500])
@pytest.mark.parametrize("bits", [3, 5])
@pytest.mark.parametrize("K,N", PACKED_ROWS_KN)
def test_psi_matmul_packed_bf16_tight_prefill_rows(cuda, K, N, bits, M):
    _check_tight(cuda, K, N, bits, M)


@pytest.mark.parametrize("bits", [3, 5])
@pytest.mark.parametrize("K,N", PACKED_ROWS_KN)
def test_psi_matmul_packed_prefill_rows_batch_invariant(cuda, K, N, bits):
    _check_batch_invariant(K, N, bits, Ms=(288, 320))


@pytest.mark.parametrize("K,N,bits,M", [
    (K, N, bits, M) for K, N in PACKED_ROWS_KN for bits in (3, 5)
    for M in (288, 320)] + [(4096, 1024, 4, 288), (4096, 1024, 6, 288)])
def test_psi_matmul_packed_routes_bit_equal_at_the_same_rows(cuda, K, N,
                                                            bits, M):
    """At the same M, kernel 2's prefill route and its decode route give
    the same bits (the wrapper picks the route by M and N alone), the
    narrow weights too (N <= 256: forced onto the prefill route here);
    bits 4 and 6 at one shape, so that every width the route builds runs
    here or in the misaligned cases (2, 5, 7)."""
    from repro_torch.kernels import psi_matmul as pm
    data, scale = _packed_weight(K, N, bits)
    x = _x(M, K, M * 7 + K + bits)
    chunk, _ = pm.split_plan(K, N, _build.sm_count(0))
    assert torch.equal(pm._packed_launch(x, data, scale, bits, None, chunk, 1),
                       pm._packed_launch(x, data, scale, bits, None, chunk, 0))


@pytest.mark.parametrize("bits", [3, 5])
@pytest.mark.parametrize("K,N", PACKED_ROWS_KN)
def test_psi_matmul_packed_prefill_rows_f32_out_casts_bit_equal(cuda, K, N,
                                                               bits):
    """Kernel 2's f32 output at M = 288 (a row-parallel partial, cast after
    its all-reduce): its cast to bf16 is the bf16 output bit for bit, and
    its rows are those of an M = 4 f32 launch."""
    data, scale = _packed_weight(K, N, bits)
    qt = psi.QuantizedTensor(data, scale, psi.get_format(bits), True)
    x = _x(288, K, K * 5 + N + bits)
    y32 = ops.psi_matmul_2d(x, qt, out_dtype=torch.float32)
    assert y32.dtype == torch.float32
    assert torch.equal(y32.to(torch.bfloat16), ops.psi_matmul_2d(x, qt))
    for i in (0, 140, 284):
        assert torch.equal(ops.psi_matmul_2d(
            x[i:i + 4].contiguous(), qt, out_dtype=torch.float32),
            y32[i:i + 4]), i


# ---------------------------------------------------------------------------
# The decode step and the horizon-M round as CUDA graphs.
# ---------------------------------------------------------------------------
def _graph_executor(dtype, horizon, arch=None):
    """A psi8 executor on the card with two prefilled slots and a live
    block table: (executor, cache, table, inputs).  The reduced qwen3-8b,
    or ``arch`` at full width cut to 2 layers."""
    from repro_torch.runtime import Executor
    if arch is None:
        cfg = reduced_config(get_config("qwen3-8b"), quant_mode="psi8",
                             dtype=dtype)
    else:
        cfg = get_config(arch, n_layers=2, quant_mode="psi8", dtype=dtype)
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
                   cache.n_blocks,
                   None if cache.enc_out is None else cache.enc_out.clone())


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
    _graph_vs_eager_steps(*_graph_executor(dtype, 1))


def _graph_vs_eager_steps(ex, cache, bt, inp):
    """Two horizon-1 graph replays against two eager decode_steps on a copy
    of the pool (see test_decode_graph_replay_equals_eager_step)."""
    ref_cache = _pool_copy(cache)
    L = ex.model.cfg.n_layers
    per = _matmuls_per_forward(ex.model.cfg)
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
                == per
            assert after["paged_attention"] - before["paged_attention"] == L
        inp["token"] = got.cpu().numpy()[:, None]
        inp["pos"] = inp["pos"] + 1
    assert ex.graph_counts() == {"decode": 1, "decode_multi": 0,
                                 "draft": 0, "verify": 0}
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
    assert ex.graph_counts() == {"decode": 0, "decode_multi": 1,
                                 "draft": 0, "verify": 0}


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


# ---------------------------------------------------------------------------
# Context serving on the card: the suffix prefill, a decode graph over a
# table that preemption and restore rewrote, and the launches of a chunk.
# ---------------------------------------------------------------------------
# kernel 1's prefill rows in the context-serving phase of chip_smoke.py:
# bucketed prompts and suffixes (multiples of 16 up to 480) and 128-token
# chunks; 16 and 64 are covered above
CTX_M = [32, 48, 128, 288, 304, 448, 480]


@pytest.mark.parametrize("M", CTX_M)
@pytest.mark.parametrize("K,N", QWEN_KN)
def test_ctx_psi_matmul_codes_bf16_prefill_rows(cuda, K, N, M):
    _check_tight(cuda, K, N, 8, M)


def _suffix_vs_full(dtype, P=48, split=32):
    """Reduced qwen3-8b psi8 on the card: the last logits and the suffix's
    K/V rows of a P-token prompt prefilled whole, and prefilled as its
    first ``split`` tokens (scattered into the pool) plus a suffix prefill
    over that context gathered back from the pool."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced_config(get_config("qwen3-8b"), quant_mode="psi8",
                         dtype=dtype)
    model = build_model(cfg)
    params = model.init(seed=0, device="cuda", bits=8)
    g = torch.Generator().manual_seed(P + split)
    prompt = torch.randint(0, cfg.vocab_size, (1, P), generator=g).cuda()
    with torch.inference_mode():
        full, seq_full = model.prefill(params, prompt)
        cache = model.init_cache(1, 64, device="cuda", n_blocks=4)
        row = torch.tensor([3, 1, 0, 2], device="cuda")
        _, seq = model.prefill(params, prompt[:, :split])
        model.insert_cache(cache, seq, 0, row)
        ctx = model.gather_prefix_ctx(cache, row[:split // 16])
        part, seq_part = model.prefill(params, prompt[:, split:], pos0=split,
                                       ctx_kv=ctx)
    return full.float(), part.float(), seq_full, seq_part, split


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ctx_suffix_prefill_matches_full_prefill(cuda, dtype):
    """f32: the two paths sum the same terms in other orders — 1e-4 on the
    logits and 1e-5 on the K/V rows, as the CPU tests hold the port to the
    JAX package.  bf16: every activation rounds to bf16 (2^-9 relative),
    and a rounding that differs between the paths moves what follows by
    up to an ulp of bf16 (2^-8): 2^-5 of the largest logit for the logits
    and 2^-6 of the largest K/V value for the rows leave room for a few
    such flips through the two layers."""
    full, part, seq_full, seq_part, split = _suffix_vs_full(dtype)
    f32 = dtype == "float32"
    tol = 1e-4 if f32 else 2.0 ** -5 * float(full.abs().max())
    assert float((full - part).abs().max()) <= tol
    assert int(full.argmax()) == int(part.argmax())
    for a, b in zip(seq_full.kv, seq_part.kv):
        assert torch.equal(b["k_pos"][0], a["k_pos"][0, split:])
        for k in ("k", "v"):
            want, got = a[k][:, split:].float(), b[k].float()
            kv_tol = 1e-5 if f32 else 2.0 ** -6 * float(want.abs().max())
            assert float((want - got).abs().max()) <= kv_tol, k


def test_ctx_decode_graph_after_preemption_and_restore(cuda):
    """The horizon-1 graph is captured over one table; then a preemption
    clears slot 1's row and a restore gives slot 2 a row that starts with
    a block slot 0 shares (its prompt's first block) and ends with fresh
    blocks filled by a suffix prefill.  Two replays equal two eager
    decode_steps on a copy of the pool, tokens and pools bit for bit; the
    shared block is never written; the table buffer keeps its address."""
    from repro_torch.runtime import Executor
    cfg = reduced_config(get_config("qwen3-8b"), quant_mode="psi8",
                         dtype="bfloat16")
    params = build_model(cfg).init(seed=0, device="cuda", bits=8)
    ex = Executor(cfg, params, max_batch=3, max_seq=64, device="cuda")
    cache = ex.init_cache()
    bt = ex.make_block_table()
    ptr = bt.device().data_ptr()
    rng = np.random.default_rng(3)
    p0 = rng.integers(0, cfg.vocab_size, size=(1, 40)).astype(np.int32)
    p1 = rng.integers(0, cfg.vocab_size, size=(1, 16)).astype(np.int32)
    rows = {0: [0, 1, 2, -1], 1: [3, 4, -1, -1]}
    toks = {}
    for slot, p in ((0, p0), (1, p1)):
        row = np.array(rows[slot], np.int32)
        first, _ = ex.prefill_insert(
            np.pad(p, ((0, 0), (0, -p.shape[1] % 16))),
            np.array([p.shape[1]], np.int32), cache, slot, row)
        bt[slot] = row
        toks[slot] = int(first[0])
    inp = dict(token=np.array([[toks[0]], [toks[1]], [0]], np.int32),
               pos=np.array([[40], [16], [0]], np.int32),
               active=np.array([True, True, False]))
    got, _ = ex.decode(inp["token"], inp["pos"], inp["active"], cache, bt)
    assert ex.graph_counts() == {"decode": 1, "decode_multi": 0,
                                 "draft": 0, "verify": 0}
    # preempt slot 1; restore slot 2 over slot 0's shared first block
    bt[1, :] = -1
    inp["active"][1] = False
    tail = rng.integers(0, cfg.vocab_size, size=(1, 20)).astype(np.int32)
    row2 = np.array([0, 5, 6, -1], np.int32)
    bt[2] = row2
    shared = [{k: t[0].clone() for k, t in layer.items()}
              for layer in cache.kv]
    suffix = np.zeros((1, 32), np.int32)
    suffix[0, :20] = tail
    first2, _ = ex.prefill_insert(suffix, np.array([20], np.int32), cache,
                                  2, row2, ctx_ids=row2[:1])
    inp["token"] = np.array([[int(got[0])], [0], [int(first2[0])]],
                            np.int32)
    inp["pos"] = np.array([[41], [0], [36]], np.int32)
    inp["active"] = np.array([True, False, True])
    ref_cache = _pool_copy(cache)
    for step in range(2):
        with torch.inference_mode():
            logits, _ = ex.model.decode_step(
                ex.params, _eager_batch(inp, bt), ref_cache)
        want = torch.argmax(logits, -1).to(torch.int32)
        got, _ = ex.decode(inp["token"], inp["pos"], inp["active"], cache,
                           bt)
        assert torch.equal(got, want), step
        inp["token"] = got.cpu().numpy()[:, None]
        inp["pos"] = inp["pos"] + 1
    assert ex.graph_counts() == {"decode": 1, "decode_multi": 0,
                                 "draft": 0, "verify": 0}
    _assert_pools_equal(cache, ref_cache)
    for layer, old in zip(cache.kv, shared):
        for k in layer:
            assert torch.equal(layer[k][0], old[k]), k
    assert bt.device().data_ptr() == ptr == ex._bt.data_ptr()
    assert ex._bt.cpu().numpy().tolist() == bt.host.tolist()


def test_ctx_chunk_without_lm_head_launches_252(cuda):
    """qwen3-8b's depth (36 layers) at reduced width: a chunk that is not
    the last skips the lm-head — 252 PSI launches — and the last piece
    runs it — 253."""
    from repro_torch.runtime import Executor
    cfg = reduced_config(get_config("qwen3-8b"), quant_mode="psi8",
                         n_layers=36)
    params = build_model(cfg).init(seed=0, device="cuda", bits=8)
    ex = Executor(cfg, params, max_batch=1, max_seq=64, device="cuda")
    cache = ex.init_cache()
    row = np.array([0, 1, 2, 3], np.int32)
    toks = np.arange(32, dtype=np.int32)[None]
    counts = []
    for cur, emit in ((0, False), (16, True)):
        before = ops.launch_counts()
        first, _ = ex.prefill_insert(toks[:, cur:cur + 16],
                                     np.array([16], np.int32), cache, 0, row,
                                     ctx_ids=row[:cur // 16], emit=emit)
        after = ops.launch_counts()
        counts.append(after["psi_matmul_codes"] - before["psi_matmul_codes"])
        assert (first is None) == (not emit)
    assert counts == [252, 253]
    assert ex.prefill_headless == 1 and ex.prefill_calls == 2


# ---------------------------------------------------------------------------
# Self-speculative decoding on the card: the draft and verify graphs, kernel
# 3 at the verify's shape, and no CUDA tensor on a plain version.
# ---------------------------------------------------------------------------
def _spec_executor(dtype, bits):
    """A reduced qwen3-8b executor with a (3, 4) speculative pair over
    psi``bits`` codes (packed below 8 bits: the psi3 draft then runs
    kernel 2), two prefilled slots, a live table and an inactive slot."""
    from repro_torch.runtime import Executor
    cfg = reduced_config(get_config("qwen3-8b"), quant_mode=f"psi{bits}",
                         dtype=dtype)
    params = build_model(cfg).init(seed=0, device="cuda", bits=bits,
                                   pack=True, qat_precondition=3)
    ex = Executor(cfg, params, max_batch=3, max_seq=64, device="cuda",
                  speculative=(3, 4))
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
                  active=np.array([True, True, False]))
    return ex, cache, bt, inputs


def _eager_round(ex, inp, bt, ref_cache):
    """The draft's k decode steps and the verify, eagerly, on ``ref_cache``:
    ((B, k) drafts, (B, k) verdicts)."""
    batch = _eager_batch(inp, bt)
    tok, pos, drafts = batch["token"], batch["pos"], []
    with torch.inference_mode():
        for _ in range(ex.spec_k):
            logits, _ = ex.model.decode_step(
                ex.draft_params, dict(batch, token=tok, pos=pos), ref_cache)
            tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
            pos = pos + 1
            drafts.append(tok[:, 0])
        drafts = torch.stack(drafts, 1)
        tokens = torch.cat([batch["token"], drafts[:, :-1]], 1)
        logits, _ = ex.model.verify_step(
            ex.params, {"tokens": tokens, "pos0": batch["pos"],
                        "active": batch["active"],
                        "block_table": batch["block_table"]}, ref_cache)
    return drafts, torch.argmax(logits, -1).to(torch.int32)


@pytest.mark.parametrize("bits", [8, 5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_spec_graphs_equal_eager_bodies(cuda, dtype, bits):
    """Two speculative rounds as draft and verify graph replays against the
    same bodies run eagerly on a copy of the pool: drafts, verdicts and
    pools bit for bit.  Between the rounds the table changes under the
    graphs (slot 0 gets a fresh block for positions 32-47, slot 1 is
    cleared and made inactive, slot 2 takes two blocks); each replay adds
    k decode steps' and one verify's launches: (k + 1) (7 n_layers + 1)
    matmuls and (k + 1) n_layers attention calls."""
    ex, cache, bt, inp = _spec_executor(dtype, bits)
    ref_cache = _pool_copy(cache)
    L, k = ex.model.cfg.n_layers, ex.spec_k
    key = "psi_matmul_codes" if bits == 8 else "psi_matmul_packed"
    for rnd in range(2):
        want_d, want_v = _eager_round(ex, inp, bt, ref_cache)
        before = ops.launch_counts()
        drafts, _ = ex.draft(inp["token"], inp["pos"], inp["active"], cache,
                             bt)
        verdicts, _ = ex.verify(inp["token"], drafts, inp["pos"],
                                inp["active"], cache, bt)
        after = ops.launch_counts()
        np.testing.assert_array_equal(np.asarray(drafts),
                                      want_d.cpu().numpy())
        np.testing.assert_array_equal(np.asarray(verdicts),
                                      want_v.cpu().numpy())
        _assert_pools_equal(cache, ref_cache)
        if rnd:                      # the first calls also ran warm steps
            assert after[key] - before[key] == (k + 1) * (7 * L + 1)
            assert after["paged_attention"] - before["paged_attention"] == \
                (k + 1) * L
        bt[0, 2] = 6
        bt[1, :] = -1
        bt[2, :2] = [4, 5]
        inp["token"] = np.asarray(verdicts)[:, -1:].astype(np.int32)
        inp["pos"] = np.array([[29], [0], [3]], np.int32)
        inp["active"] = np.array([True, False, True])
    assert ex.graph_counts() == {"decode": 0, "decode_multi": 0,
                                 "draft": 1, "verify": 1}
    assert ex.spec_cache_sizes() == {"draft": 1, "verify": 1, "decode": 0}


@pytest.mark.parametrize("mode", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("shape", [(4, 2, 16, 16), (32, 8, 128, 16)])
def test_paged_attention_verify_shape_matches_plain(cuda, mode, shape):
    """Kernel 3 at the verify's shape: B * k query rows whose tables repeat
    each slot's k times (jnp.repeat's order), consecutive positions that
    cross a block boundary, and an inactive slot (table all -1)."""
    hq, hkv, hd, bs = shape
    B, k, n_bt = 4, 4, 5
    g = torch.Generator().manual_seed(hq + k)
    N = B * n_bt + B
    qdt = torch.bfloat16 if mode == "bf16" else torch.float32
    q = torch.randn(B * k, hq, hd, generator=g).to(qdt)
    if mode == "int8":
        kp, vp = (torch.randint(-127, 128, (N, bs, hkv, hd), generator=g,
                                dtype=torch.int8) for _ in range(2))
        ks, vs = (torch.rand(N, bs, hkv, 1, generator=g) * 0.05
                  for _ in range(2))
    else:
        kp, vp = (torch.randn(N, bs, hkv, hd, generator=g).to(qdt)
                  for _ in range(2))
        ks = vs = None
    bt = torch.randperm(B * n_bt, generator=g).to(torch.int32).reshape(
        B, n_bt)
    bt[2] = -1                                       # an inactive slot
    pos0 = torch.tensor([bs - 2, 2 * bs - 1, 0, 3 * bs + 5],
                        dtype=torch.int32)
    pos = (pos0[:, None] + torch.arange(k, dtype=torch.int32)).reshape(-1)
    tables = bt.repeat_interleave(k, 0).contiguous()
    case = (q, kp, vp, tables, pos, ks, vs)
    want = pa.paged_attention_ref(*case)
    before = ops.launch_counts()["paged_attention"]
    got = ops.paged_decode_attention(
        *(None if t is None else t.to(cuda) for t in case)).cpu()
    assert ops.launch_counts()["paged_attention"] == before + 1
    rows = torch.ones(B * k, dtype=torch.bool)
    rows[2 * k:3 * k] = False
    assert bool((got[~rows] == 0).all())
    # chip_smoke.py's per-element bound: A, the plain version on |V|, is
    # the size of the terms each output sums
    a = pa.paged_attention_ref(q, kp, vp.abs(), tables, pos, ks,
                               vs)[rows].float()
    want = want[rows].float()
    tol = (2.0 ** -7 * want.abs() + 2.0 ** -5 * a if mode == "bf16"
           else 1e-5 * (want.abs() + a))
    d = (got[rows].float() - want).abs()
    assert bool((d <= tol).all()), float((d - tol).max())


def test_spec_serve_never_hands_a_cuda_tensor_to_a_plain_version(
        cuda, monkeypatch):
    """A speculative serve on the card (psi5 packed target, psi3 draft)
    reaches only the kernels: no plain version is called with a CUDA
    tensor, and the launch counts are exactly (k + 1) (7 n_layers + 1)
    matmuls and (k + 1) n_layers attention calls per round plus 7 n_layers
    + 1 per prefill; the tokens equal the CPU's."""
    cfg = reduced_config(get_config("qwen3-8b"), quant_mode="psi5")
    params = build_model(cfg).init(seed=0, device="cpu", bits=5, pack=True,
                                   qat_precondition=3)
    trace = lambda: scheduler.poisson_trace(
        4, rate_rps=1e9, prompt_len=12, max_new=9, vocab_size=256, seed=3,
        prompt_jitter=4)
    cpu = serve.Server(cfg, params, max_batch=2, max_seq=64, device="cpu",
                       speculative=(3, 4))
    want = {r.rid: r.tokens for r in cpu.serve(trace())[0]}
    bad = []
    for mod, name in ((ref, "psi_matmul_codes_ref"),
                      (ref, "psi_matmul_packed_ref"),
                      (pa, "paged_attention_ref")):
        real = getattr(mod, name)

        def guarded(*a, _real=real, _name=name, **kw):
            if any(isinstance(t, torch.Tensor) and t.is_cuda for t in a):
                bad.append(_name)
            return _real(*a, **kw)
        monkeypatch.setattr(mod, name, guarded)
    server = serve.Server(cfg, params, max_batch=2, max_seq=64,
                          device="cuda", speculative=(3, 4))
    server.warmup(trace())
    ops.reset_launch_counts()
    done, stats = server.serve(trace(), warmup=False)
    counts = ops.launch_counts()
    assert not bad, bad
    assert {r.rid: r.tokens for r in done} == want
    per, L, k = 7 * cfg.n_layers + 1, cfg.n_layers, 4
    rounds = stats["decode_steps"]
    assert counts == {"psi_matmul_codes": 0,
                      "psi_matmul_packed": per * ((k + 1) * rounds
                                                  + stats["prefill_forwards"]),
                      "paged_attention": (k + 1) * L * rounds}
    assert stats["speculative"]["spec_compiles"] == {"draft": 1,
                                                     "verify": 1,
                                                     "decode": 0}
    assert stats["blocks_free_end"] == stats["n_blocks"]


# ---------------------------------------------------------------------------
# The other dense configs (phi3-medium-14b, granite-34b, chatglm3-6b): the
# kernels at their full-width weight shapes and head layouts, the decode
# graph over their full-width layers, and a reduced serve against the CPU.
# ---------------------------------------------------------------------------
ARCHS = ["phi3-medium-14b", "granite-34b", "chatglm3-6b"]
# (K, N) of wq/wo, wk/wv, w_gate/w_up (granite: w_up), w_down, lm_head;
# chatglm3's wq/wo (4096, 4096) is qwen3-8b's, in QWEN_KN above; then
# qwen3-moe-30b-a3b's wq, wk/wv, wo and lm_head (its experts take no PSI
# kernel)
ARCH_KN = [(5120, 5120), (5120, 1280), (5120, 17920), (17920, 5120),
           (5120, 100352),
           (6144, 6144), (6144, 128), (6144, 24576), (24576, 6144),
           (6144, 49152),
           (4096, 256), (4096, 13696), (13696, 4096), (4096, 65024),
           (2048, 4096), (2048, 512), (4096, 2048), (2048, 151936)]
# (Hq, Hkv) at D 128: phi3 (G 4), granite (MQA, G 48), chatglm3 (G 16),
# qwen3-moe (G 8)
ARCH_HEADS = [(40, 10), (48, 1), (32, 2), (32, 4)]


@pytest.mark.parametrize("M", [1, 4, 16, 64])
@pytest.mark.parametrize("K,N", ARCH_KN)
def test_psi_matmul_codes_arch_shapes_tight(cuda, K, N, M):
    _check_tight(cuda, K, N, 8, M)


@pytest.mark.parametrize("M", [1, 4, 16, 64])
@pytest.mark.parametrize("bits", [3, 5])
@pytest.mark.parametrize("K,N", ARCH_KN)
def test_psi_matmul_packed_arch_shapes_tight(cuda, K, N, bits, M):
    _check_tight(cuda, K, N, bits, M)


@pytest.mark.parametrize("bits", [8, 5])
@pytest.mark.parametrize("K,N", ARCH_KN)
def test_psi_matmul_arch_shapes_batch_invariant(cuda, K, N, bits):
    _check_batch_invariant(K, N, bits)


@pytest.mark.parametrize("mode", ["f32", "int8"])
@pytest.mark.parametrize("hq,hkv", ARCH_HEADS)
def test_paged_attention_arch_heads_serve_table(cuda, hq, hkv, mode):
    """Each head layout at the serve's table (4 slots, 7 entries: one
    split), against the plain version as test_paged_attention_matches_plain
    holds it."""
    for seed in range(2):
        case = _case(seed, 4, 7, mode, hq, hkv, 128, 16)
        want = pa.paged_attention_ref(*case)
        got = ops.paged_decode_attention(
            *(None if t is None else t.to(cuda) for t in case)).cpu()
        bt, pos = case[3], case[4]
        j = torch.arange(bt.shape[1]) * 16
        rows = ((bt >= 0) & (j[None] <= pos[:, None])).any(dim=1)
        torch.testing.assert_close(got[rows], want[rows], rtol=1e-4,
                                   atol=1e-4)
        assert bool((got[~rows] == 0).all())


@pytest.mark.parametrize("q_mul", [1.0, 4.0])
@pytest.mark.parametrize("n_bt", [64, 160])
@pytest.mark.parametrize("hq,hkv", ARCH_HEADS)
def test_paged_attention_arch_heads_bf16_split(cuda, hq, hkv, n_bt, q_mul):
    """bf16 q and pool at each head layout over tables the kernel splits:
    the per-element check of the split path, then the tight bound of
    test_paged_attention_bf16_tight against the plain version in f32."""
    G = hq // hkv
    case = _split_case(hq * 100 + n_bt, n_bt, G, hkv, 128, "bf16", cuda,
                       q_mul=q_mul)
    _check_split(case)
    q, kp, vp, bt, pos, _, _ = case
    got = ops.paged_decode_attention(*case).float()
    q32, k32, v32 = (t.float() for t in (q, kp, vp))
    want = pa.paged_attention_ref(q32, k32, v32, bt, pos)
    a = pa.paged_attention_ref(q32, k32, v32.abs(), bt, pos)
    j = torch.arange(bt.shape[1], device=bt.device) * 16
    rows = ((bt >= 0) & (j[None] <= pos[:, None])).any(dim=1)
    d = (got - want)[rows].abs()
    tol = 2.0 ** -7 * (want[rows].abs() + a[rows])
    assert bool((d <= tol).all()), float((d - tol).max())


@pytest.mark.parametrize("arch", ["granite-34b", "chatglm3-6b",
                                  "qwen3-moe-30b-a3b"])
def test_arch_decode_graph_replay_equals_eager_step(cuda, arch):
    """The horizon-1 graph of a full-width 2-layer model (granite: one kv
    head and 48 query heads on it, the GELU MLP; chatglm3: 2-D RoPE;
    qwen3-moe: the MoE FFN of 128 experts captured, routing included)
    against eager decode_steps, bit for bit at f32, with one step's
    launches per replay."""
    _graph_vs_eager_steps(*_graph_executor("float32", 1, arch))


@pytest.mark.parametrize("arch", ARCHS + ["qwen3-moe-30b-a3b"])
def test_arch_serving_on_the_card_matches_the_cpu(cuda, arch):
    """The reduced arch at psi8 (float32): the same params and trace give
    the same greedy tokens on the card and the CPU, with exact launch
    counts on the card."""
    cfg = reduced_config(get_config(arch), quant_mode="psi8")
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
    assert done["cuda"] == done["cpu"]
    assert counts == {
        "psi_matmul_codes": _matmuls_per_forward(cfg) * (
            stats["decode_steps"] + stats["prefill_forwards"]),
        "psi_matmul_packed": 0,
        "paged_attention": cfg.n_layers * stats["decode_steps"]}


# ---------------------------------------------------------------------------
# The dense layout (per-slot slabs, the SWA ring) and burst prefill on the
# card: the decode and round graphs over the slab, a burst's rows against
# their prefills alone at full width, and a dense serve that reaches only
# the kernels.
# ---------------------------------------------------------------------------
DENSE_CASES = {
    # label: (bits, dtype, kv_quant, SWA window)
    "psi8-f32": (8, "float32", "", 0),
    "psi8-bf16": (8, "bfloat16", "", 0),
    "psi5-f32": (5, "float32", "", 0),
    "psi5-bf16": (5, "bfloat16", "", 0),
    "psi8-bf16-int8kv": (8, "bfloat16", "int8", 0),
    "psi8-f32-ring": (8, "float32", "", 16),
    "psi8-bf16-ring": (8, "bfloat16", "", 16),
}


def _dense_executor(case, horizon):
    """A reduced qwen3-8b executor on the dense slab (the SWA ring of 16
    positions when the case has a window, its prompts then 20 and 13
    tokens so slot 0's ring has already rolled), two prefilled slots and
    an inactive one: (executor, cache, inputs)."""
    from repro_torch.runtime import Executor
    bits, dtype, kvq, window = DENSE_CASES[case]
    over = (dict(attn_type="swa", window=window) if window
            else dict(cache_layout="dense"))
    cfg = reduced_config(get_config("qwen3-8b"), quant_mode=f"psi{bits}",
                         dtype=dtype, kv_quant=kvq, **over)
    params = build_model(cfg).init(seed=0, device="cuda", bits=bits,
                                   pack=bits < 8)
    ex = Executor(cfg, params, max_batch=3, max_seq=64, device="cuda",
                  decode_horizon=horizon)
    cache = ex.init_cache()
    rng = np.random.default_rng(0)
    lens = (20, 13) if window else (13, 13)
    for slot, n in enumerate(lens):
        sb = n if n > 16 and window else -(-n // 16) * 16
        prompt = np.zeros((1, sb), np.int32)
        prompt[0, :n] = rng.integers(0, cfg.vocab_size, size=n)
        ex.prefill_insert(prompt, np.array([n], np.int32), cache, slot)
    inputs = dict(token=np.array([[5], [7], [0]], np.int32),
                  pos=np.array([[lens[0]], [lens[1]], [0]], np.int32),
                  active=np.array([True, True, False]),
                  remaining=np.array([20, 3, 0], np.int32))
    return ex, cache, inputs


def _dense_batch(inputs, with_round=False):
    b = {k: torch.from_numpy(inputs[k]).cuda()
         for k in ("token", "pos", "active")}
    if with_round:
        b["remaining"] = torch.from_numpy(inputs["remaining"]).cuda()
        b["eos_id"] = torch.tensor(-1, dtype=torch.int32, device="cuda")
    return b


def _assert_slabs_equal(cache, ref_cache):
    """Every slab entry bit for bit (no scratch: an inactive row writes
    nothing)."""
    for a, b in zip(cache.kv, ref_cache.kv):
        for k in a:
            assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("case", list(DENSE_CASES))
def test_dense_decode_graph_replay_equals_eager_step(cuda, case):
    """Three horizon-1 graph replays over the slab against eager
    decode_steps on a copy: tokens and slabs bit for bit (the ring wraps
    on slot 0), one step's PSI launches per replay and no paged-attention
    launch."""
    ex, cache, inp = _dense_executor(case, 1)
    ref_cache = _pool_copy(cache)
    per = _matmuls_per_forward(ex.model.cfg)
    for step in range(3):
        with torch.inference_mode():
            logits, _ = ex.model.decode_step(ex.params, _dense_batch(inp),
                                             ref_cache)
        want = torch.argmax(logits, -1).to(torch.int32)
        before = ops.launch_counts()
        got, _ = ex.decode(inp["token"], inp["pos"], inp["active"], cache)
        after = ops.launch_counts()
        assert torch.equal(got, want), step
        key = "psi_matmul_codes" if DENSE_CASES[case][0] == 8 \
            else "psi_matmul_packed"
        if step:                     # the first call also ran the warm step
            assert after[key] - before[key] == per
        assert after["paged_attention"] == before["paged_attention"]
        inp["token"] = got.cpu().numpy()[:, None]
        inp["pos"] = inp["pos"] + 1
    assert ex.graph_counts() == {"decode": 1, "decode_multi": 0,
                                 "draft": 0, "verify": 0}
    _assert_slabs_equal(cache, ref_cache)


@pytest.mark.parametrize("case", list(DENSE_CASES))
def test_dense_round_graph_equals_eager_steps(cuda, case):
    """One horizon-4 round graph over the slab against Model.decode_scan,
    eagerly, on a copy: tokens, carry and slabs bit for bit; slot 1's
    budget of 3 ends inside the round; the carry chains into a second
    round."""
    ex, cache, inp = _dense_executor(case, 4)
    ref_cache = _pool_copy(cache)
    with torch.inference_mode():
        want, wcarry, _ = ex.model.decode_scan(
            ex.params, _dense_batch(inp, True), ref_cache, 4)
    toks, carry, _ = ex.decode_multi(inp["token"], inp["pos"],
                                     inp["active"], inp["remaining"], cache)
    np.testing.assert_array_equal(np.asarray(toks), want.cpu().numpy())
    for k in ("token", "pos", "remaining"):
        assert torch.equal(carry[k], wcarry[k].to(torch.int32)), k
    assert carry["active"].tolist() == [1, 0, 0]
    _assert_slabs_equal(cache, ref_cache)
    toks2, _, _ = ex.decode_multi(carry["token"], carry["pos"],
                                  carry["active"], carry["remaining"], cache)
    with torch.inference_mode():
        want2, _, _ = ex.model.decode_scan(
            ex.params, dict(wcarry, eos_id=torch.tensor(
                -1, dtype=torch.int32, device="cuda")), ref_cache, 4)
    np.testing.assert_array_equal(np.asarray(toks2), want2.cpu().numpy())
    _assert_slabs_equal(cache, ref_cache)
    assert ex.graph_counts() == {"decode": 0, "decode_multi": 1,
                                 "draft": 0, "verify": 0}


@pytest.mark.parametrize("bits", [8, 5])
@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_burst_rows_equal_alone_full_width(cuda, layout, bits):
    """qwen3-8b at full width, 2 layers, bf16: four prompts of four buckets
    (64, 80, 32, 16) in one burst forward give each row's first token and
    cache rows bit for bit as its prefill alone (kernels 1 and 2 take the
    burst's 4 x 80 rows; attention runs per row at its own bucket)."""
    from repro_torch.runtime import Executor
    cfg = get_config("qwen3-8b", n_layers=2, quant_mode=f"psi{bits}",
                     dtype="bfloat16", cache_layout=layout)
    params = build_model(cfg).init(seed=0, device="cuda", bits=bits,
                                   pack=bits < 8)
    ex = Executor(cfg, params, max_batch=4, max_seq=112, device="cuda")
    rng = np.random.default_rng(5)
    lens, buckets = [64, 72, 20, 9], [64, 80, 32, 16]
    toks = np.zeros((4, 80), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, cfg.vocab_size, size=n)
    first, burst = ex.prefill(toks, np.asarray(lens, np.int32),
                              row_lens=buckets)
    for i, (n, sb) in enumerate(zip(lens, buckets)):
        f1, alone = ex.prefill(toks[i:i + 1, :sb], np.asarray([n], np.int32))
        assert int(f1[0]) == int(first[i]), i
        for lb, la in zip(burst.kv, alone.kv):
            for name in la:
                assert torch.equal(lb[name][i, :sb], la[name][0, :sb]), \
                    (i, name)
                if layout == "dense":
                    assert torch.equal(lb["k_pos"][i], la["k_pos"][0])


@pytest.mark.parametrize("case", ["dense", "dense-h4", "swa-16"])
def test_dense_serve_reaches_only_the_kernels(cuda, case, monkeypatch):
    """A reduced psi8 serve on the dense layout (float32), continuous then
    static: the same tokens as the CPU (the SWA ring of 16 wraps; a burst
    of long prompts takes the one-by-one fallback), no CUDA tensor on a
    plain version, and exactly (7 n_layers + 1) PSI launches per decode
    step and per prefill forward, none of kernel 3."""
    over = ({"attn_type": "swa", "window": 16} if case == "swa-16"
            else {"cache_layout": "dense"})
    horizon = 4 if case == "dense-h4" else 1
    cfg = reduced_config(get_config("qwen3-8b"), quant_mode="psi8", **over)
    params = build_model(cfg).init(seed=0, device="cpu", bits=8)
    lens = ([20, 23, 18, 10, 14, 12] if case == "swa-16"
            else [12, 9, 15, 30, 7, 11])

    def trace():
        rng = np.random.default_rng(9)
        return [scheduler.Request(rid=i, prompt=rng.integers(
            0, cfg.vocab_size, size=n).astype(np.int32), max_new=6 + i % 4)
            for i, n in enumerate(lens)]
    want = {}
    cpu = serve.Server(cfg, params, max_batch=3, max_seq=64, device="cpu",
                       decode_horizon=horizon)
    for mode in (True, False):
        want[mode] = {r.rid: r.tokens
                      for r in cpu.serve(trace(), continuous=mode)[0]}
    bad = []
    for mod, name in ((ref, "psi_matmul_codes_ref"),
                      (ref, "psi_matmul_packed_ref"),
                      (pa, "paged_attention_ref")):
        real = getattr(mod, name)

        def guarded(*a, _real=real, _name=name, **kw):
            if any(isinstance(t, torch.Tensor) and t.is_cuda for t in a):
                bad.append(_name)
            return _real(*a, **kw)
        monkeypatch.setattr(mod, name, guarded)
    server = serve.Server(cfg, params, max_batch=3, max_seq=64,
                          device="cuda", decode_horizon=horizon)
    server.warmup(trace())
    per = _matmuls_per_forward(cfg)
    for mode in (True, False):
        ops.reset_launch_counts()
        done, stats = server.serve(trace(), continuous=mode, warmup=False)
        counts = ops.launch_counts()
        assert not bad, bad
        assert {r.rid: r.tokens for r in done} == want[mode], mode
        assert counts == {"psi_matmul_codes": per * (
            stats["decode_steps"] + stats["prefill_forwards"]),
            "psi_matmul_packed": 0, "paged_attention": 0}
        assert stats["cache_layout"] == "dense"
        assert stats["decode_compiles"] == 1
        if not mode and case == "swa-16":
            assert stats["prefill_forwards"] == 4    # 3 alone + 1 burst
        elif not mode:
            assert stats["prefill_forwards"] == 2    # two bursts of 3


# ---------------------------------------------------------------------------
# The MoE family (qwen3-moe-30b-a3b): the MoE FFN on the card against the
# CPU, and the routing of a padded burst.  Its PSI shapes and its 32/4 head
# layout are in ARCH_KN and ARCH_HEADS above.
# ---------------------------------------------------------------------------
MOE = "qwen3-moe-30b-a3b"


def _moe_layer(cfg, bits, seed=0):
    """One layer's MoE leaves on the card at ``cfg``'s widths: router in
    f32, the expert blocks quantized (psi5 packed)."""
    from repro_torch.core import quantizer
    from repro_torch.models import moe
    gen = torch.Generator(device="cuda").manual_seed(seed)
    p = {}
    for path, shape, std in moe.param_specs(cfg, "moe"):
        w = torch.randn(shape, generator=gen, device="cuda") * std
        p[path.split("/")[-1]] = quantizer.quantize_leaf(path, w, bits,
                                                         pack=bits < 8)
    return p


@pytest.mark.parametrize("bits", [8, 5])
@pytest.mark.parametrize("width", ["reduced", "full"])
@pytest.mark.parametrize("cf", [1.0, 8.0])
def test_moe_ffn_card_matches_cpu(cuda, width, bits, cf):
    """moe_ffn on the card against the CPU plain path on the same leaves
    and inputs, 2 x 80 tokens (the full width at one layer: C = 5 at cf 1
    against a mean load of 5, so tokens drop; none at cf 8, where C
    covers S at the reduced width and far exceeds the load at the full
    one): slots and keep exact; y within 1e-4 of O(1)
    outputs in float32, and within 2^-6 of the output's largest magnitude
    in bf16 (the card's f32 products of bf16 blocks through out_dtype, the
    CPU's through an f32 upcast: sums in another order, rounded to bf16
    at h, ye and each combine step)."""
    from repro_torch.models import moe
    cfg = get_config(MOE) if width == "full" else reduced_config(
        get_config(MOE))
    cfg = dataclasses.replace(cfg, capacity_factor=cf,
                              quant_mode=f"psi{bits}")
    p = _moe_layer(cfg, bits)
    pc = {k: v.to("cpu") for k, v in p.items()}
    x = torch.randn(2, 80, cfg.d_model,
                    generator=torch.Generator().manual_seed(1))
    for dtype in (torch.float32, torch.bfloat16):
        want, _ = moe.moe_ffn(pc, x.to(dtype), cfg)
        _, ws, wk, _, _ = moe.route(pc, x.to(dtype), cfg)
        with torch.inference_mode():
            got, _ = moe.moe_ffn(p, x.to(cuda, dtype), cfg)
            _, gs, gk, _, _ = moe.route(p, x.to(cuda, dtype), cfg)
        assert got.dtype == dtype
        assert torch.equal(gs.cpu(), ws) and torch.equal(gk.cpu(), wk)
        tol = 1e-4 if dtype == torch.float32 else \
            2 ** -6 * float(want.float().abs().max())
        torch.testing.assert_close(got.cpu().float(), want.float(), rtol=0,
                                   atol=tol)
        assert bool(wk.all()) == (cf == 8.0)    # cf 1 drops tokens


def test_moe_burst_routes_pads_as_whole_rows(cuda):
    """An MoE burst runs attention over each whole padded row, as the JAX
    package does (no per-row extents): pad positions route and take
    capacity, so a row's routing equals that row prefilled alone at the
    burst's padded length (not at its own bucket).  Reduced qwen3-moe at
    psi8, float32, capacity factor 1: per layer the same slots and keep,
    the same first token, cache rows within 1e-5."""
    from repro_torch.models import moe
    from repro_torch.runtime import Executor
    cfg = reduced_config(get_config(MOE), quant_mode="psi8",
                         capacity_factor=1.0)
    params = build_model(cfg).init(seed=0, device="cuda", bits=8)
    ex = Executor(cfg, params, max_batch=3, max_seq=64, device="cuda")
    rng = np.random.default_rng(2)
    lens = [13, 30, 9]
    toks = np.zeros((3, 32), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, cfg.vocab_size, size=n)
    routes = []
    real = moe.route

    def logged(*a, **kw):
        out = real(*a, **kw)
        routes.append(out[1:3])
        return out
    moe.route = logged
    try:
        first, burst = ex.prefill(toks, np.asarray(lens, np.int32))
        burst_routes, routes[:] = list(routes), []
        for i, n in enumerate(lens):
            f1, alone = ex.prefill(toks[i:i + 1], np.asarray([n], np.int32))
            assert int(f1[0]) == int(first[i]), i
            for (bs_, bk), (as_, ak) in zip(burst_routes, routes):
                assert torch.equal(bs_[i], as_[0]) and torch.equal(bk[i],
                                                                   ak[0])
            for lb, la in zip(burst.kv, alone.kv):
                torch.testing.assert_close(lb["k"][i], la["k"][0], rtol=0,
                                           atol=1e-5)
            routes[:] = []
    finally:
        moe.route = real
    assert not all(bool(k.all()) for _, k in burst_routes)   # drops


# ---------------------------------------------------------------------------
# The VLM (qwen2-vl-2b) and the RG-LRU hybrid (recurrentgemma-9b): kernels 1
# and 2 at their new full-width weight shapes, kernel 3 at qwen2-vl's 12/2
# (G = 6: a head block of 8 with 2 dead heads), the rec block on the card
# against the CPU at one full-width layer, the hybrid's decode and round
# graphs against eager steps with an idle slot, and reduced serves against
# the CPU.
# ---------------------------------------------------------------------------
VLM, HYBRID = "qwen2-vl-2b", "recurrentgemma-9b"
# qwen2-vl's wq/wo, wk/wv, w_gate/w_up, w_down, tied head; recurrentgemma's
# tied head (its other shapes are qwen3-8b's and granite's wk/wv, above)
VLM_HYB_KN = [(1536, 1536), (1536, 256), (1536, 8960), (8960, 1536),
              (1536, 151936), (4096, 256000)]


@pytest.mark.parametrize("M", [1, 4, 16, 64])
@pytest.mark.parametrize("K,N", VLM_HYB_KN)
def test_psi_matmul_codes_vlm_hybrid_shapes_tight(cuda, K, N, M):
    _check_tight(cuda, K, N, 8, M)


@pytest.mark.parametrize("M", [1, 4, 16, 64])
@pytest.mark.parametrize("K,N", VLM_HYB_KN)
def test_psi_matmul_packed_vlm_hybrid_shapes_tight(cuda, K, N, M):
    _check_tight(cuda, K, N, 5, M)


@pytest.mark.parametrize("bits", [8, 5])
@pytest.mark.parametrize("K,N", VLM_HYB_KN)
def test_psi_matmul_vlm_hybrid_shapes_batch_invariant(cuda, K, N, bits):
    _check_batch_invariant(K, N, bits)


@pytest.mark.parametrize("mode", ["f32", "int8"])
def test_paged_attention_12_2_serve_table(cuda, mode):
    """12/2 (G = 6) at the serve's table, against the plain version."""
    test_paged_attention_arch_heads_serve_table(cuda, 12, 2, mode)


@pytest.mark.parametrize("q_mul", [1.0, 4.0])
@pytest.mark.parametrize("n_bt", [32, 128])
def test_paged_attention_12_2_bf16_split(cuda, n_bt, q_mul):
    """bf16 12/2 over split tables of 512 and 2048 positions a slot: the
    split path per element and the tight bound (4 x 80 is one split: the
    serve-table case above)."""
    test_paged_attention_arch_heads_bf16_split(cuda, 12, 2, n_bt, q_mul)


def _rec_layer(cfg, seed=0):
    """One full-width rec block's leaves on the card, PSI leaves at psi8."""
    from repro_torch.core import quantizer
    from repro_torch.models import rglru
    gen = torch.Generator(device="cuda").manual_seed(seed)
    p = {}
    for path, shape, init in rglru.param_specs(cfg, "rec"):
        if isinstance(init, tuple):
            w = torch.full(shape, init[1], device="cuda")
        else:
            w = torch.randn(shape, generator=gen, device="cuda") * init
        if quantizer.is_quantizable(path, w):
            w = quantizer.quantize_leaf(path, w, 8)
        p[path.split("/")[-1]] = w
    return p


def test_rglru_card_matches_cpu_full_width(cuda):
    """rglru_block over 2 x 80 tokens (and from a carried h), then three
    decode steps, float32, on the card against the CPU on the same leaves:
    outputs and state h, conv within 1e-4 (f32 sums of K = 4096 in other
    orders)."""
    from repro_torch.models import rglru
    cfg = get_config(HYBRID, dtype="float32", quant_mode="psi8")
    p = _rec_layer(cfg)
    pc = {k: v.to("cpu") for k, v in p.items()}
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 80, cfg.d_model, generator=g)
    h0 = torch.randn(2, cfg.resolved_d_rnn, generator=g)
    tol = dict(rtol=0, atol=1e-4)
    for state in (None, {"h": h0}):
        with torch.inference_mode():
            got, gs = rglru.rglru_block(
                p, x.to(cuda), cfg,
                None if state is None else {"h": h0.to(cuda)})
        want, ws = rglru.rglru_block(pc, x, cfg, state)
        torch.testing.assert_close(got.cpu(), want, **tol)
        for k in ("h", "conv"):
            torch.testing.assert_close(gs[k].cpu(), ws[k], **tol)
    for i in range(3):
        xt = torch.randn(2, 1, cfg.d_model, generator=g)
        with torch.inference_mode():
            got, gs = rglru.rglru_decode_step(p, xt.to(cuda), cfg, gs)
        want, ws = rglru.rglru_decode_step(pc, xt, cfg, ws)
        torch.testing.assert_close(got.cpu(), want, **tol)
        for k in ("h", "conv"):
            torch.testing.assert_close(gs[k].cpu(), ws[k], **tol)


def _hybrid_executor(dtype, horizon):
    """Full-width recurrentgemma-9b cut to 3 layers (rec, rec, attn) on the
    card, psi8, with slots 0 and 1 prefilled (20 and 13 tokens) and slot 2
    idle: (executor, cache, inputs)."""
    from repro_torch.runtime import Executor
    cfg = get_config(HYBRID, n_layers=3, quant_mode="psi8", dtype=dtype)
    params = build_model(cfg).init(seed=0, device="cuda", bits=8)
    ex = Executor(cfg, params, max_batch=3, max_seq=64, device="cuda",
                  decode_horizon=horizon)
    cache = ex.init_cache()
    rng = np.random.default_rng(0)
    for slot, n in enumerate((20, 13)):
        prompt = rng.integers(0, cfg.vocab_size, size=(1, n)).astype(
            np.int32)
        ex.prefill_insert(prompt, np.array([n], np.int32), cache, slot)
    inputs = dict(token=np.array([[5], [7], [0]], np.int32),
                  pos=np.array([[20], [13], [0]], np.int32),
                  active=np.array([True, True, False]),
                  remaining=np.array([20, 3, 0], np.int32))
    return ex, cache, inputs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hybrid_decode_graph_equals_eager_with_an_idle_slot(cuda, dtype):
    """Three horizon-1 graph replays against eager decode_steps on a copy
    of the cache: tokens, slabs and rec state bit for bit; the idle slot's
    state frozen (still zero) in both; one step's PSI launches per replay
    (8 a rec layer, 7 an attention layer, the head) and no kernel-3
    launch."""
    ex, cache, inp = _hybrid_executor(dtype, 1)
    ref_cache = _pool_copy(cache)
    per = _matmuls_per_forward(ex.model.cfg)
    assert per == 2 * 8 + 7 + 1
    for step in range(3):
        with torch.inference_mode():
            logits, _ = ex.model.decode_step(ex.params, _dense_batch(inp),
                                             ref_cache)
        want = torch.argmax(logits, -1).to(torch.int32)
        before = ops.launch_counts()
        got, _ = ex.decode(inp["token"], inp["pos"], inp["active"], cache)
        after = ops.launch_counts()
        assert torch.equal(got, want), step
        if step:
            assert after["psi_matmul_codes"] - before["psi_matmul_codes"] \
                == per
        assert after["paged_attention"] == before["paged_attention"]
        inp["token"] = got.cpu().numpy()[:, None]
        inp["pos"] = inp["pos"] + 1
    _assert_slabs_equal(cache, ref_cache)
    for layer in cache.kv[:2]:                     # the two rec layers
        assert not layer["h"][2].any() and not layer["conv"][2].any()
        assert layer["h"][0].any()


def test_hybrid_round_graph_equals_eager_steps(cuda):
    """One horizon-4 round graph against Model.decode_scan eagerly on a
    copy (slot 1's budget of 3 ends inside the round, slot 2 idle):
    tokens, carry, slabs and rec state bit for bit."""
    ex, cache, inp = _hybrid_executor("float32", 4)
    ref_cache = _pool_copy(cache)
    with torch.inference_mode():
        want, wcarry, _ = ex.model.decode_scan(
            ex.params, _dense_batch(inp, True), ref_cache, 4)
    toks, carry, _ = ex.decode_multi(inp["token"], inp["pos"],
                                     inp["active"], inp["remaining"], cache)
    np.testing.assert_array_equal(np.asarray(toks), want.cpu().numpy())
    for k in ("token", "pos", "remaining"):
        assert torch.equal(carry[k], wcarry[k].to(torch.int32)), k
    assert carry["active"].tolist() == wcarry["active"].int().tolist() \
        == [1, 0, 0]
    _assert_slabs_equal(cache, ref_cache)
    assert not cache.kv[0]["h"][2].any()


@pytest.mark.parametrize("arch", [VLM, HYBRID])
def test_vlm_hybrid_serving_on_the_card_matches_the_cpu(cuda, arch):
    """The reduced arch at psi8 (float32), prompts of unequal lengths:
    the same greedy tokens on the card and the CPU, continuous and static,
    with exact launch counts on the card (kernel 3 only for the paged
    VLM) and one prefill forward a request for the hybrid in static
    mode."""
    cfg = reduced_config(get_config(arch), quant_mode="psi8")
    params = build_model(cfg).init(seed=0, device="cpu", bits=8)
    trace = lambda: scheduler.poisson_trace(
        4, rate_rps=1e9, prompt_len=26, max_new=10, vocab_size=256, seed=3,
        prompt_jitter=4)
    done = {}
    for dev in ("cpu", "cuda"):
        server = serve.Server(cfg, params, max_batch=2, max_seq=64,
                              device=dev)
        server.warmup(trace())
        for continuous in (True, False):
            ops.reset_launch_counts()
            reqs, stats = server.serve(trace(), continuous=continuous,
                                       warmup=False)
            done[(dev, continuous)] = {r.rid: r.tokens for r in reqs}
            counts = ops.launch_counts()
            if dev == "cuda":
                paged = server.paged
                assert counts == {
                    "psi_matmul_codes": _matmuls_per_forward(cfg) * (
                        stats["decode_steps"] + stats["prefill_forwards"]),
                    "psi_matmul_packed": 0,
                    "paged_attention": (cfg.n_layers * stats["decode_steps"]
                                        if paged else 0)}
            if arch == HYBRID and not continuous:
                assert stats["prefill_forwards"] == stats["n_requests"]
    for continuous in (True, False):
        assert done[("cuda", continuous)] == done[("cpu", continuous)]


# ---------------------------------------------------------------------------
# The SSM (falcon-mamba-7b) and the encoder-decoder (whisper-base): kernels
# 1 and 2 at their weight shapes (the SSM's x_proj / dt_proj_w also on the
# f32 route its prefill takes, at M 1-288, batch invariant; whisper's
# 512-wide matrices at the encoder's and cross K/V's 1500 and 6000 rows; its
# odd 51865-wide tied head), the mamba block and a whisper decoder layer on
# the card against the CPU at full width, the mamba decode graph and the
# whisper round graph against eager steps with an idle slot, and reduced
# serves against the CPU.
# ---------------------------------------------------------------------------
SSM, ENCDEC = "falcon-mamba-7b", "whisper-base"
# falcon-mamba's in_proj, x_proj, dt_proj_w, out_proj, lm-head; whisper's
# wq/wk/wv/wo (self and cross), w_up, w_down, tied head
SSM_KN = [(4096, 16384), (8192, 288), (256, 8192), (8192, 4096),
          (4096, 65024)]
ENCDEC_KN = [(512, 512), (512, 2048), (2048, 512), (512, 51865)]


@pytest.mark.parametrize("M", [1, 4, 16, 64, 288])
@pytest.mark.parametrize("K,N", SSM_KN + ENCDEC_KN)
def test_psi_matmul_codes_ssm_encdec_shapes_tight(cuda, K, N, M):
    _check_tight(cuda, K, N, 8, M)


@pytest.mark.parametrize("M", [1, 4, 16, 64])
@pytest.mark.parametrize("K,N", SSM_KN + ENCDEC_KN)
def test_psi_matmul_packed_ssm_encdec_shapes_tight(cuda, K, N, M):
    _check_tight(cuda, K, N, 5, M)


@pytest.mark.parametrize("M", [1500, 6000])
@pytest.mark.parametrize("K,N", ENCDEC_KN[:3])
def test_psi_matmul_codes_encoder_rows_tight(cuda, K, N, M):
    """The encoder's 1500 rows a request and the cross K/V's 4 x 1500 rows
    a decode step."""
    _check_tight(cuda, K, N, 8, M)


@pytest.mark.parametrize("bits", [8, 5])
@pytest.mark.parametrize("K,N", SSM_KN + ENCDEC_KN)
def test_psi_matmul_ssm_encdec_shapes_batch_invariant(cuda, K, N, bits):
    _check_batch_invariant(K, N, bits)


@pytest.mark.parametrize("M", [1, 2, 5, 16, 59, 64, 256, 288])
@pytest.mark.parametrize("bits", [8, 5])
@pytest.mark.parametrize("K,N", SSM_KN[1:3])
def test_psi_matmul_f32_route_ssm_prefill_rows(cuda, K, N, bits, M):
    """x_proj and dt_proj_w on f32 rows (the SSM prefill's dtype): the
    CUDA-core route against the plain version within 1e-5 of the largest
    output (f32 sums in another order)."""
    data, scale = _packed_weight(K, N, bits)
    qt = psi.QuantizedTensor(data, scale, psi.get_format(bits), bits < 8)
    g = torch.Generator(device="cuda").manual_seed(M + K)
    x = torch.randn(M, K, generator=g, device="cuda")
    got = ops.psi_matmul_2d(x, qt)
    assert got.dtype == torch.float32
    codes = psi.unpack_codes(data, bits) if bits < 8 else data
    want = ref.psi_matmul_codes_ref(x, codes, scale)
    tol = 1e-5 * max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= tol


@pytest.mark.parametrize("bits", [8, 5])
@pytest.mark.parametrize("K,N", SSM_KN[1:3])
def test_psi_matmul_f32_route_batch_invariant(cuda, K, N, bits):
    """The f32 route's rows do not depend on the batch: 288 rows at once,
    as 256 + 32, and one by one (a prefill of 288 tokens, or chunks of
    it), bit for bit."""
    data, scale = _packed_weight(K, N, bits)
    qt = psi.QuantizedTensor(data, scale, psi.get_format(bits), bits < 8)
    g = torch.Generator(device="cuda").manual_seed(K + N)
    x = torch.randn(288, K, generator=g, device="cuda")
    whole = ops.psi_matmul_2d(x, qt)
    parts = torch.cat([ops.psi_matmul_2d(x[:256], qt),
                       ops.psi_matmul_2d(x[256:], qt)])
    assert torch.equal(whole, parts)
    for i in range(0, 288, 37):
        assert torch.equal(ops.psi_matmul_2d(x[i:i + 1], qt)[0], whole[i])


def _layer_leaves(specs, seed=0):
    """A layer's leaves from ``param_specs`` on the card, PSI leaves at
    psi8 (mamba's own inits through ``ssm.init_leaf``)."""
    from repro_torch.core import quantizer
    from repro_torch.models import ssm
    gen = torch.Generator(device="cuda").manual_seed(seed)
    p = {}
    for path, shape, init in specs:
        if init is None:
            w = torch.ones(shape, device="cuda")
        elif isinstance(init, tuple) and init[0] == "fill":
            w = torch.full(shape, init[1], device="cuda")
        elif isinstance(init, tuple):
            w = ssm.init_leaf(init, shape, gen, "cuda")
        else:
            w = torch.randn(shape, generator=gen, device="cuda") * init
        if quantizer.is_quantizable(path, w):
            w = quantizer.quantize_leaf(path, w, 8)
        node = p
        keys = path.split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = w
    return p


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.to("cpu")


def test_mamba_card_matches_cpu_full_width(cuda):
    """mamba_block over 2 x 80 tokens, then three decode steps, float32,
    on the card against the CPU on the same leaves: outputs and the ssm /
    conv state within 1e-4 (f32 sums of K up to 8192 in other orders)."""
    from repro_torch.models import ssm
    cfg = get_config(SSM, dtype="float32", quant_mode="psi8")
    p = _layer_leaves(ssm.param_specs(cfg, "m"))["m"]
    pc = _to_cpu(p)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 80, cfg.d_model, generator=g)
    tol = dict(rtol=0, atol=1e-4)
    with torch.inference_mode():
        got, gs = ssm.mamba_block(p, x.to(cuda), cfg)
    want, ws = ssm.mamba_block(pc, x, cfg)
    torch.testing.assert_close(got.cpu(), want, **tol)
    for k in ("ssm", "conv"):
        torch.testing.assert_close(gs[k].cpu(), ws[k], **tol)
    for _ in range(3):
        xt = torch.randn(2, 1, cfg.d_model, generator=g)
        with torch.inference_mode():
            got, gs = ssm.mamba_decode_step(p, xt.to(cuda), cfg, gs)
        want, ws = ssm.mamba_decode_step(pc, xt, cfg, ws)
        torch.testing.assert_close(got.cpu(), want, **tol)
        for k in ("ssm", "conv"):
            torch.testing.assert_close(gs[k].cpu(), ws[k], **tol)


def test_whisper_decoder_layer_card_matches_cpu_full_width(cuda):
    """One full-width xattn layer, float32: a 2 x 24-token prefill over a
    random 2 x 1500-frame encoder output, then three decode steps on the
    dense slab, on the card against the CPU: outputs within 1e-4."""
    from repro_torch.models import attention, transformer
    cfg = get_config(ENCDEC, n_layers=1, dtype="float32",
                     quant_mode="psi8")
    model = build_model(cfg)
    specs = [(path.split("/", 2)[2], shape, init)
             for path, shape, init in model.param_specs()
             if path.startswith("layers/0/")]
    p = _layer_leaves(specs)
    pc = _to_cpu(p)
    g = torch.Generator().manual_seed(2)
    enc = torch.randn(2, cfg.enc_frames, cfg.d_model, generator=g)
    x = torch.randn(2, 24, cfg.d_model, generator=g)
    pos = torch.arange(24, dtype=torch.int32)[None].expand(2, 24)
    tol = dict(rtol=0, atol=1e-4)
    with torch.inference_mode():
        got, gst = transformer.apply_block(p, x.to(cuda), cfg, "xattn",
                                           pos.to(cuda), enc_out=enc.to(cuda))
    want, wst = transformer.apply_block(pc, x, cfg, "xattn", pos,
                                        enc_out=enc)
    torch.testing.assert_close(got.cpu(), want, **tol)
    caches = {}
    for dev, st in (("cuda", gst), ("cpu", wst)):
        c = attention.init_kv_cache(cfg, 2, 32, torch.float32, dev)
        c["k"][:, :24], c["v"][:, :24] = st["k"], st["v"]
        c["k_pos"][:, :24] = st["k_pos"]
        caches[dev] = c
    for i in range(3):
        xt = torch.randn(2, 1, cfg.d_model, generator=g)
        pt = torch.full((2, 1), 24 + i, dtype=torch.int32)
        with torch.inference_mode():
            got, _ = transformer.apply_block_decode(
                p, xt.to(cuda), cfg, "xattn", pt.to(cuda), caches["cuda"],
                enc_out=enc.to(cuda))
        want, _ = transformer.apply_block_decode(
            pc, xt, cfg, "xattn", pt, caches["cpu"], enc_out=enc)
        torch.testing.assert_close(got.cpu(), want, **tol)


def _slice_executor(arch, dtype, horizon):
    """Full-width ``arch`` cut to 2 layers (whisper: 2 encoder layers over
    its 1500 frames) on the card, psi8, with slots 0 and 1 prefilled (20
    and 13 tokens) and slot 2 idle: (executor, cache, inputs)."""
    from repro_torch.runtime import Executor
    over = {"n_enc_layers": 2} if arch == ENCDEC else {}
    cfg = get_config(arch, n_layers=2, quant_mode="psi8", dtype=dtype,
                     **over)
    params = build_model(cfg).init(seed=0, device="cuda", bits=8)
    ex = Executor(cfg, params, max_batch=3, max_seq=64, device="cuda",
                  decode_horizon=horizon)
    cache = ex.init_cache()
    rng = np.random.default_rng(0)
    for slot, n in enumerate((20, 13)):
        prompt = rng.integers(0, cfg.vocab_size, size=(1, n)).astype(
            np.int32)
        ex.prefill_insert(prompt, np.array([n], np.int32), cache, slot)
    inputs = dict(token=np.array([[5], [7], [0]], np.int32),
                  pos=np.array([[20], [13], [0]], np.int32),
                  active=np.array([True, True, False]),
                  remaining=np.array([20, 3, 0], np.int32))
    return ex, cache, inputs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_decode_graph_equals_eager_with_an_idle_slot(cuda, dtype):
    """Three horizon-1 graph replays against eager decode_steps on a copy
    of the cache: tokens and mamba state bit for bit; the idle slot's
    state frozen (still zero) in both; 4 PSI launches a layer and the head
    per replay, no kernel-3 launch."""
    ex, cache, inp = _slice_executor(SSM, dtype, 1)
    ref_cache = _pool_copy(cache)
    per = _matmuls_per_forward(ex.model.cfg)
    assert per == 2 * 4 + 1
    for step in range(3):
        with torch.inference_mode():
            logits, _ = ex.model.decode_step(ex.params, _dense_batch(inp),
                                             ref_cache)
        want = torch.argmax(logits, -1).to(torch.int32)
        before = ops.launch_counts()
        got, _ = ex.decode(inp["token"], inp["pos"], inp["active"], cache)
        after = ops.launch_counts()
        assert torch.equal(got, want), step
        if step:
            assert after["psi_matmul_codes"] - before["psi_matmul_codes"] \
                == per
        assert after["paged_attention"] == before["paged_attention"]
        inp["token"] = got.cpu().numpy()[:, None]
        inp["pos"] = inp["pos"] + 1
    _assert_slabs_equal(cache, ref_cache)
    for layer in cache.kv:
        assert not layer["ssm"][2].any() and not layer["conv"][2].any()
        assert layer["ssm"][0].any()


def test_whisper_round_graph_equals_eager_steps(cuda):
    """One horizon-4 round graph against Model.decode_scan eagerly on a
    copy (slot 1's budget of 3 ends inside the round, slot 2 idle):
    tokens, carry and slabs bit for bit; the idle slot's slab rows and
    every ``enc_out`` row untouched (slot 2's still zero)."""
    ex, cache, inp = _slice_executor(ENCDEC, "float32", 4)
    assert _matmuls_per_forward(ex.model.cfg) == 2 * 10 + 1
    assert _matmuls_per_forward(ex.model.cfg, prefill=True) == 33
    ref_cache = _pool_copy(cache)
    enc = cache.enc_out.clone()
    assert enc[0].any() and enc[1].any() and not enc[2].any()
    with torch.inference_mode():
        want, wcarry, _ = ex.model.decode_scan(
            ex.params, _dense_batch(inp, True), ref_cache, 4)
    toks, carry, _ = ex.decode_multi(inp["token"], inp["pos"],
                                     inp["active"], inp["remaining"], cache)
    np.testing.assert_array_equal(np.asarray(toks), want.cpu().numpy())
    for k in ("token", "pos", "remaining"):
        assert torch.equal(carry[k], wcarry[k].to(torch.int32)), k
    assert carry["active"].tolist() == wcarry["active"].int().tolist() \
        == [1, 0, 0]
    _assert_slabs_equal(cache, ref_cache)
    assert torch.equal(cache.enc_out, enc)
    assert (cache.kv[0]["k_pos"][2] == -1).all()


@pytest.mark.parametrize("arch", [SSM, ENCDEC])
def test_ssm_encdec_serving_on_the_card_matches_the_cpu(cuda, arch):
    """The reduced arch at psi8 (float32), prompts of unequal lengths (and
    of 1 and 2 tokens for the SSM): the same greedy tokens on the card and
    the CPU, continuous and static, with exact launch counts on the card
    (no kernel 3; whisper's encoder at every prefill forward) and one
    prefill forward a request in static mode."""
    cfg = reduced_config(get_config(arch), quant_mode="psi8")
    params = build_model(cfg).init(seed=0, device="cpu", bits=8)

    def trace():
        reqs = scheduler.poisson_trace(
            4, rate_rps=1e9, prompt_len=26, max_new=10, vocab_size=256,
            seed=3, prompt_jitter=4)
        if arch == SSM:
            reqs[1].prompt, reqs[2].prompt = reqs[1].prompt[:1], \
                reqs[2].prompt[:2]
        return reqs
    done = {}
    for dev in ("cpu", "cuda"):
        server = serve.Server(cfg, params, max_batch=2, max_seq=64,
                              device=dev)
        server.warmup(trace())
        for continuous in (True, False):
            ops.reset_launch_counts()
            reqs, stats = server.serve(trace(), continuous=continuous,
                                       warmup=False)
            done[(dev, continuous)] = {r.rid: r.tokens for r in reqs}
            counts = ops.launch_counts()
            if dev == "cuda":
                fwd = stats["prefill_forwards"]
                assert counts == {
                    "psi_matmul_codes": _matmuls_per_forward(cfg) * (
                        stats["decode_steps"] + fwd)
                    + (_matmuls_per_forward(cfg, prefill=True)
                       - _matmuls_per_forward(cfg)) * fwd,
                    "psi_matmul_packed": 0, "paged_attention": 0}
            if not continuous:
                assert stats["prefill_forwards"] == stats["n_requests"]
    for continuous in (True, False):
        assert done[("cuda", continuous)] == done[("cpu", continuous)]


# ------------------------------------------------------ training and CNNs
@pytest.fixture
def no_tf32(cuda):
    """f32 products and convolutions in IEEE f32 on the card (the CPU
    comparisons below), restored after the test."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield cuda
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


@pytest.mark.parametrize("bits,axis", [(8, (0,)), (5, (1,)), (3, None),
                                       (8, (0, 1, 2))])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fake_quant_ste_on_the_card(cuda, bits, axis, dtype):
    """The STE's forward on the card bit-equal to the CPU's (abs, max,
    division, round half to even, clip, the PSI table: exact operations),
    its gradient the incoming one."""
    shape = (3, 3, 8, 16) if axis == (0, 1, 2) else (64, 48)
    w = torch.randn(shape, generator=torch.Generator().manual_seed(bits)
                    ).to(dtype)
    want = psi.fake_quant_ste(w, bits, axis)
    wc = w.to(cuda).requires_grad_(True)
    got = psi.fake_quant_ste(wc, bits, axis)
    assert got.dtype == dtype and torch.equal(got.detach().cpu(), want)
    c = torch.randn(shape, device=cuda).to(dtype)
    (g,) = torch.autograd.grad((got * c).sum(), wc)
    assert torch.equal(g, c)


def test_train_step_card_matches_cpu(no_tf32):
    """One ``make_train_step`` step of reduced qwen3-8b at qat8 (f32) from
    the same params and batch: the loss within 1e-5 relative, the
    gradients' global norm within 1e-4, every parameter within 2 lr of
    the CPU's (Adam's first step moves each weight by lr x sign(g): a
    gradient that is a rounding error off 0 can take either sign)."""
    from repro_torch.data import TokenStream
    from repro_torch.launch import train as tr
    from repro_torch.optim import adamw
    from repro_torch.core.quantizer import tree_leaves, tree_map
    cfg = reduced_config(get_config("qwen3-8b"), quant_mode="qat8")
    model = build_model(cfg)
    init = model.init(0, "cpu")
    toks = torch.from_numpy(next(TokenStream(cfg.vocab_size, 64, 4)))
    lr = 3e-4
    out = {}
    for dev in ("cpu", no_tf32):
        opt = adamw(lr=lr)
        p = tree_map(lambda t: t.clone().to(dev), init)
        step = tr.make_train_step(model, opt)
        p, st, _, met = step(p, opt.init(p), {}, {"tokens": toks.to(dev)})
        out[str(dev)] = (float(met["loss"]), float(met["grad_norm"]),
                         [t.detach().cpu() for t in tree_leaves(p)])
    (lc, gc, pc), (lg, gg, pg) = out["cpu"], out["cuda"]
    assert abs(lg - lc) <= 1e-5 * abs(lc)
    assert abs(gg - gc) <= 1e-4 * gc
    for a, b in zip(pg, pc):
        assert float((a - b).abs().max()) <= 2 * lr * (1 + 1e-3)


@pytest.mark.parametrize("net,batch", [("lenet5", 8), ("alexnet", 2)])
@pytest.mark.parametrize("mode", ["none", "qat5", "psi8"])
def test_cnn_forward_card_matches_cpu(no_tf32, net, batch, mode):
    """LeNet-5 and AlexNet forwards on the card against the CPU from the
    same params, within 1e-4 of the largest logit (f32 convolutions,
    cuDNN against oneDNN: other summation orders); psi8 from
    ``quantize_cnn`` codes (bit-equal on both devices)."""
    from repro_torch.models import cnn
    from repro_torch.core.quantizer import tree_map
    dev = no_tf32
    base = cnn.LENET5 if net == "lenet5" else cnn.ALEXNET
    cfg = dataclasses.replace(base, quant_mode=mode)
    p = cnn.init_cnn(base, 0, "cpu")
    pd = tree_map(lambda t: t.to(dev), p)
    if mode == "psi8":
        p, qd = cnn.quantize_cnn(p, 8), cnn.quantize_cnn(pd, 8)
        pd = tree_map(lambda t: t.to(dev), p)
        for k in p:
            w = "convk" if k.startswith("conv") else "w"
            assert torch.equal(qd[k][w].data.cpu(), p[k][w].data)
    x = torch.randn((batch,) + base.in_shape,
                    generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        want = cnn.cnn_forward(p, x, cfg)
        got = cnn.cnn_forward(pd, x.to(dev), cfg).cpu()
    assert got.shape == (batch, base.n_classes)
    assert float((got - want).abs().max()) <= 1e-4 * float(
        want.abs().max())


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_mesh_server_world1_nccl_matches_single(cuda, tmp_path, layout):
    """A Server on a (1, 1) mesh of a world-1 NCCL process group (what
    chip_smoke.py's serve_psi8_mesh runs at full width): tokens identical
    to the same params without a mesh, one slot shard, token all-gathers
    issued on the card, the decode graph captured once; the roofline
    stats read the card's power limit."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime import parallel
    cfg = reduced_config(get_config("qwen3-8b"), quant_mode="psi8",
                         cache_layout=layout, dtype="bfloat16")
    params = build_model(cfg).init(seed=0, device=cuda, bits=8)
    plain = serve.Server(cfg, params, max_batch=4, max_seq=64, device=cuda)
    trace = lambda: scheduler.poisson_trace(  # noqa: E731
        6, rate_rps=1e9, prompt_len=12, max_new=8, vocab_size=256, seed=3,
        prompt_jitter=4)
    want, _ = plain.serve(trace())
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        server = serve.Server(cfg, params, max_batch=4, max_seq=64,
                              device=cuda, mesh=mesh)
        parallel.reset_collective_counts()
        got, st = server.serve(trace())
        assert ({r.rid: r.tokens for r in got}
                == {r.rid: r.tokens for r in want})
        assert st["slot_shards"] == 1 and st["decode_compiles"] == 1
        assert parallel.collective_counts()["all_gather"] >= st[
            "decode_steps"] > 0
        assert st["watts"] > 0 and st["tokens_per_joule"] > 0
        assert st["mfu"] > 0
    finally:
        dist.destroy_process_group()


def test_card_power_limit_by_uuid(cuda):
    """A CUDA Server's default board power: the limit nvidia-smi reports
    for this process's card, asked for by the card's UUID (the same
    physical card whatever CUDA_VISIBLE_DEVICES says)."""
    import subprocess
    out = subprocess.run(["nvidia-smi", "--query-gpu=uuid,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    limits = dict(line.split(", ") for line in out.stdout.strip().splitlines())
    uuid = serve.card_uuid(torch.device(cuda))
    assert uuid in limits, (uuid, limits)
    assert serve.card_power_limit(uuid) == float(limits[uuid].split()[0])
