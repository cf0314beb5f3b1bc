"""The port's CUDA kernels and serving path on a card, against the plain
PyTorch versions on the same inputs.  No JAX here, so the file runs on a
machine with a card and PyTorch only:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Every test skips when no CUDA device is present.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.core import psi
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
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
