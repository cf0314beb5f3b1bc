"""Operations and bytes against sums written out by hand at a toy
shape: d 8, 2 query heads and 1 KV head of 4, d_ff 16, vocab 10, 2
layers."""
import pytest

import bench_toy  # noqa: F401
from benchlib import counts

M = {"n_layers": 2, "d_model": 8, "n_heads": 2, "n_kv_heads": 1,
     "head_dim": 4, "d_ff": 16, "vocab_size": 10, "act": "swiglu"}
# wq 8x8, wk 8x4, wv 8x4, wo 8x8, w_gate / w_up 8x16, w_down 16x8
LAYER = 64 + 32 + 32 + 64 + 128 + 128 + 128          # 576 MACs a token


def test_layer_and_head_macs():
    assert counts.layer_macs(M) == 2 * LAYER
    assert counts.head_macs(M) == 80
    gelu = dict(M, act="gelu")
    assert counts.layer_macs(gelu) == 2 * (LAYER - 128)


def test_decode_flops():
    # contexts 3 and 5: each token 2*576 + 80 MACs, attention 2 layers x
    # 2 (score and value) x 2 heads x 4 dims = 32 MACs a key
    want = 2 * (2 * (2 * LAYER + 80) + 32 * (3 + 5))
    assert counts.decode_flops(M, [3, 5]) == want


def test_prefill_flops_one_head_row_and_causal_pairs():
    # a 4-token prompt: 4 tokens of projections, one lm-head row, 10 pairs
    want = 2 * (4 * 2 * LAYER + 80 + 32 * 10)
    assert counts.prefill_flops(M, [4]) == want
    assert counts.prefill_psi_flops(M, [4]) == 2 * (4 * 2 * LAYER + 80)


@pytest.mark.parametrize("bits,pack,per_weight", [
    (8, False, 1.0), (5, True, 5 / 8), (5, False, 1.0)])
def test_decode_weight_bytes(bits, pack, per_weight):
    mats = [(8, 8), (8, 4), (8, 4), (8, 8), (8, 16), (8, 16), (16, 8)]
    layer = sum(k * n * per_weight + 4 * n for k, n in mats)
    head = 8 * 10 * per_weight + 4 * 10
    assert counts.decode_weight_bytes(M, bits, pack) == 2 * layer + head


def test_packing_needs_whole_bytes_of_k():
    assert counts.code_bytes(12, 4, 5, True) == 12 * 4 + 16
    assert counts.code_bytes(16, 4, 5, True) == 16 * 4 * 5 / 8 + 16
