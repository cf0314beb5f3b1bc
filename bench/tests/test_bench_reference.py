"""The benchmark's float32 reference against the port's plain path (the
CPU), at a reduced size: its own PSI rounding gives the port's codes bit
for bit, and its logits are the port's float32 forward's to rounding."""
import pytest
import torch

import bench_toy
from benchlib import program
from reference import psi as rpsi
from reference import weights
from reference.model import Reference, round_fp8


def _conf(bits, pack, act, preset):
    c = dict(bench_toy.TOY_CONFIG, quant={"bits": bits, "pack": pack})
    c["model"] = dict(bench_toy.TOY_MODEL, act=act)
    c["run"] = dict(c["run"], preset=preset)
    return c


CASES = [(8, False, "swiglu", "phi3-medium-14b"),
         (5, True, "gelu", "granite-34b")]


@pytest.mark.parametrize("bits,pack,act,preset", CASES)
def test_psi_rounding_is_the_ports(bits, pack, act, preset):
    conf = _conf(bits, pack, act, preset)
    params = program.build_params(conf, 2**31 + 5, "cpu")
    program.check_tree(program.port_config(conf), params)
    drawn = weights.draw(conf["model"], 2**31 + 5, "layers/1", "cpu")
    for name in ("attn/wq", "mlp/w_up", "mlp/w_down"):
        codes, scale = rpsi.quantize(drawn[name], bits)
        leaf = params["layers"][1][name.split("/")[0]][name.split("/")[1]]
        assert leaf.packed == (pack and bits < 8)
        assert torch.equal(leaf.codes.to(torch.float32), codes)
        assert torch.equal(leaf.scale, scale)
    emb = weights.draw(conf["model"], 2**31 + 5, "embed", "cpu")["embed"]
    codes, scale = rpsi.quantize(emb, bits, per_row=True)
    assert torch.equal(params["embed"].codes.to(torch.float32), codes)


def test_value_table_is_the_papers():
    # psi8: every INT8 code is a sum of at most four powers of two
    assert rpsi.value_table(8) == tuple(range(-128, 128))
    # psi5: 11 = 8 + 2 + 1 and 13 = 8 + 4 + 1 need three terms; two give
    # 10 or 12, and 12 or 14, and a tie goes to the smaller magnitude;
    # 15 = 16 - 1 needs two
    t = rpsi.value_table(5)
    assert t[11 + 16] == 10 and t[-11 + 16] == -10
    assert t[13 + 16] == 12 and t[15 + 16] == 15


@pytest.mark.parametrize("bits,pack,act,preset", CASES)
def test_logits_match_the_ports_float32_forward(bits, pack, act, preset):
    from repro_torch.models import build_model
    conf = _conf(bits, pack, act, preset)
    cfg = program.port_config(conf)
    params = program.build_params(conf, 11, "cpu")
    toks = torch.randint(0, 256, (1, 40), generator=torch.Generator()
                         .manual_seed(3))
    port, _ = build_model(cfg).forward(params, toks)
    ref = Reference(conf["model"], bits, 11, "cpu").logits_at(
        [toks[0]], [range(40)])[0]
    # float32 on both sides, other summation orders: ~1e-5 on logits ~4
    assert torch.allclose(port[0], ref, atol=2e-4, rtol=0)
    assert ref.abs().max() > 1.0


def test_fp8_rounding_keeps_three_mantissa_bits():
    x = torch.tensor([[448.0, 1.0, 1.0625, -3.3]])
    y = round_fp8(x)
    assert y[0, 0] == 448.0 and y[0, 1] == 1.0
    assert y[0, 2] == 1.0          # 1 + 1/16 rounds to 1 at 3 bits
    assert abs(float(y[0, 3]) + 3.25) < 1e-6
