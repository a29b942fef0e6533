"""BENCHMARK.json against the benchmark's rules: names, units and lines,
and every cell resolving to its configuration, traffic and workload files
and every per-layer metric to its reader."""

import importlib
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
PKG = ROOT / "portbench"
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
END_TO_END = {"name", "unit", "better", "bound", "source", "workloads"}
PER_LAYER = {"name", "unit", "better", "source", "layer", "moves",
             "workloads"}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert isinstance(MANIFEST["run_seconds"], int)


def test_command_and_paths():
    cmd = MANIFEST["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    for word in cmd:
        assert not word.startswith("/") and ".." not in word
    assert 1 <= len(MANIFEST["paths"]) <= 16
    for p in MANIFEST["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
        assert (ROOT / p).is_dir()
    assert any(w.startswith(tuple(MANIFEST["paths"])) for w in cmd[1:])


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_unique_and_well_formed(section):
    names = [e["name"] for e in MANIFEST[section]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_metric_entries():
    names = set()
    for m in MANIFEST["end_to_end"]:
        assert set(m) <= END_TO_END
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
        names.add(m["name"])
    assert "setup_s" in names
    e2e = {m["name"] for m in MANIFEST["end_to_end"]}
    cells = {w["name"] for w in MANIFEST["workloads"]}
    for m in MANIFEST["per_layer"]:
        assert set(m) <= PER_LAYER
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_every_cell_reports_its_metrics():
    for w in MANIFEST["workloads"]:
        per = [m for m in MANIFEST["per_layer"]
               if w["name"] in m["workloads"]]
        assert per, w["name"]
        assert w["chips"] in (1, 4)
        assert _line(w["why"])


def test_configs_resolve():
    used = {w["config"] for w in MANIFEST["workloads"]}
    files = set()
    for c in MANIFEST["configs"]:
        assert c["name"] in used
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("portbench/") and c["file"] not in files
        files.add(c["file"])
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["name"] == c["name"]
        assert sorted(body["reduced"]) == sorted(c["reduced"])
        assert "assumed" in body and "source" in body
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key)
            assert not key.endswith(("_dim", "_rank"))


def test_cells_resolve_to_files():
    from portbench import harness
    pairs = set()
    for w in MANIFEST["workloads"]:
        spec = harness.load_cell(w["name"], MANIFEST)
        assert spec["workload"]["name"] == w["name"]
        assert spec["workload"]["config"] == w["config"]
        assert spec["workload"]["traffic"] == w["traffic"]
        for key in ("why", "source", "reduced", "assumed", "limits"):
            assert key in spec["workload"], (w["name"], key)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))


def test_every_per_layer_metric_has_a_reader():
    for m in MANIFEST["per_layer"]:
        mod = importlib.import_module(f"portbench.metrics.{m['name']}")
        assert callable(mod.read)
        empty = {"spans": {}, "t0": 0.0, "t_end": 1.0, "loci": 0,
                 "trace": None, "work": {}}
        assert mod.read(empty) is None


def test_at_most_a_quarter_of_cells_on_four_chips():
    four = sum(1 for w in MANIFEST["workloads"] if w["chips"] == 4)
    assert four <= max(1, len(MANIFEST["workloads"]) // 4)


def test_check_worst_case_fits_the_budget():
    # 2 + 14 x 24 runs of run_seconds + 60, 2 x 90 a cell, 1200 spare
    s = MANIFEST["run_seconds"]
    assert (2 + 14 * 24) * (s + 60) + 24 * 180 + 1200 <= 43200
