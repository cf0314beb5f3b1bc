"""The traced run's attribution: kernels go to the call between whose
marker kernels they ran, the busy time is the union of the operations,
and idle gaps are named by the span that holds them."""
import pytest

import bench_toy  # noqa: F401
from benchlib.tracer import MARKER, attribute

OPEN, CLOSE = 900, 10_000                     # marker lengths, ns


def mark(t, length):
    return (t, t + length, MARKER)


OPS = [
    (0, 100, "copy"),                         # before the first call
    mark(200, CLOSE),                         # a close whose open was lost
    mark(3000, OPEN), (4100, 5100, "psi_gemm_codes"), (5200, 6200, "mul"),
    mark(6300, CLOSE),
    (17000, 17500, "insert"),                 # between calls
    mark(20000, OPEN), (21100, 22100, "psi_gemm_rows"), mark(22200, CLOSE),
]


def test_kernels_go_to_their_calls_matched_from_the_end():
    calls = [{"kind": "prefill"}, {"kind": "decode"}, {"kind": "prefill"}]
    tr = attribute(OPS, calls, 1e-4)
    assert tr["pairs"] == 2 and tr["markers"] == 5
    assert "psi_s" not in calls[0]
    assert calls[1]["psi_s"] == pytest.approx(1e-6)
    assert calls[1]["dev_s"] == pytest.approx(2e-6)
    assert calls[2]["psi_s"] == pytest.approx(1e-6)
    assert tr["by_call"]["decode"] == {"calls": 1, "dev_s": pytest.approx(
        2e-6), "psi_s": pytest.approx(1e-6)}


def test_busy_is_the_union_and_gaps_are_named():
    tr = attribute(OPS, [{"kind": "decode"}, {"kind": "prefill"}], 1e-4)
    # copy 100 + psi 1000 + mul 1000 + insert 500 + rows 1000 ns
    assert tr["busy_s"] == pytest.approx(3.6e-6)
    idle = tr["idle_by_span"]
    assert idle["in decode"] == pytest.approx(1e-7)
    assert idle["serve loop after decode"] == pytest.approx(
        (17000 - 6200 + 21100 - 17500) / 1e9)
    assert idle["serve loop after start"] == pytest.approx(4e-6)
    assert tr["device_ops"][0][1] == pytest.approx(1e-6)


def test_overlapping_operations_count_once():
    ops = [(0, 1000, "a"), (500, 1500, "b"), (1400, 1600, "c")]
    tr = attribute(ops, [], 1e-5)
    assert tr["busy_s"] == pytest.approx(1.6e-6)
    assert tr["idle_gaps"] == []


def test_a_trace_of_markers_alone_reads_nothing():
    assert attribute([mark(0, OPEN), mark(2000, CLOSE)], [], 1e-5) is None
