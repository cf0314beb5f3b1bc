"""The manifest's schema and the files it names, found by name."""
import json
import re
from pathlib import Path

import pytest

import bench_toy  # noqa: F401  (puts bench/ and src/ on sys.path)
from benchlib.check import NUMBERS
from benchlib.manifest import Manifest

ROOT = Path(__file__).resolve().parents[2]
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
NAME_RE = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT_RE = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
# widths a configuration may never cut
WIDTH_RE = re.compile(r"(hidden|intermediate|latent|state|proj|_dim$|_rank$"
                      r"|head|expan|experts_per_tok|n_embd|n_inner)")


def _line(s, limit=200):
    return isinstance(s, str) and 1 <= len(s) <= limit and not re.search(
        r"[\n\t]", s)


def test_top_level_keys_and_limits():
    assert set(MAN) == TOP
    assert 1 <= MAN["run_seconds"] <= 51 and isinstance(MAN["run_seconds"],
                                                        int)
    assert len(MAN["command"]) <= 32 and all(_line(w) for w in MAN["command"])
    assert 1 <= len(MAN["paths"]) <= 16
    for p in MAN["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    for w in MAN["command"]:
        if "/" in w:
            assert any(w.startswith(p + "/") for p in MAN["paths"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("group,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
])
def test_entries_have_just_their_keys(group, keys):
    assert 1 <= len(MAN[group]) <= 24
    for e in MAN[group]:
        assert set(e) == keys, e
        assert NAME_RE.fullmatch(e["name"])
        assert _line(e["why"])


@pytest.mark.parametrize("group", ["end_to_end", "per_layer"])
def test_metrics_have_just_their_keys(group):
    base = {"name", "unit", "better", "source"}
    base |= {"bound"} if group == "end_to_end" else {"layer", "moves"}
    cells = {w["name"] for w in MAN["workloads"]}
    for m in MAN[group]:
        assert set(m) - {"workloads"} == base, m
        assert NAME_RE.fullmatch(m["name"]) and UNIT_RE.fullmatch(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
        if group == "end_to_end":
            assert m["source"] in ("host_clock", "device_trace")
            assert 0.01 <= m["bound"] <= 0.25
        else:
            assert m["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
            assert _line(m["layer"])


def test_names_are_unique():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in MAN[group]]
        assert len(names) == len(set(names))
    names = [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_every_cell_finds_its_files():
    man = Manifest(ROOT)
    used = set()
    for w in MAN["workloads"]:
        assert w["chips"] in (1, 4)
        conf = man.config(w["config"])
        mix = man.traffic(w["traffic"])
        assert conf["name"] == w["config"] and mix["rate_rps"] > 0
        used.add(w["config"])
        for m in man.per_layer(w["name"]):
            assert callable(man.reader(m["name"]))
    assert used == {c["name"] for c in MAN["configs"]}
    files = [c["file"] for c in MAN["configs"]]
    assert len(files) == len(set(files))
    assert all(f.startswith("bench/configs/") for f in files)


def test_every_cell_reports_what_it_must():
    man = Manifest(ROOT)
    for w in MAN["workloads"]:
        e2e = {m["name"] for m in man.end_to_end(w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        per = man.per_layer(w["name"])
        assert per
        for m in per:
            # the end-to-end metric a per-layer metric moves is reported
            # by each of its cells
            assert m["moves"] in e2e, (w["name"], m["name"])


def test_configs_cut_no_width():
    for c in MAN["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
        assert not [k for k in c["reduced"] if WIDTH_RE.search(k)]
        m = conf["model"]
        assert m["d_model"] == m["n_heads"] * m["head_dim"]
        assert m["n_heads"] % m["n_kv_heads"] == 0
        limits = [conf["check"][k] for k in NUMBERS if k in conf["check"]]
        assert limits and all(v > 0 for v in limits)


def test_four_card_cells_are_few():
    four = [w for w in MAN["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(MAN["workloads"]) // 4)
