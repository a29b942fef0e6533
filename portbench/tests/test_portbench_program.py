"""The readers of the program's own spans and counters on a synthetic
window, what they read of a program that keeps no totals, a traced run of
each cell on the CPU at a tiny size, and the device's idle time by span
on a small synthetic trace."""

import copy
import importlib
import json
import time
from pathlib import Path

import pytest
import torch

from portbench import harness, idle
from portbench.metrics import _program

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
PROGRAM = [m for m in MANIFEST["per_layer"]
           if m["source"] in ("program_span", "program_counter")
           and (ROOT / "portbench" / "metrics" /
                f"{m['name']}.py").read_text().count("_program")]


class Call:
    def __init__(self, t0, spans, counters):
        self.call, self.t0, self.t1 = 1, t0, t0 + 1.0
        self.spans, self.counters = spans, counters


CALLS = [
    # the warm-up, before the window
    Call(50.0, {"advntr.model.bank_read": [9, 9.0, 9.0],
                "advntr.recruit": [1, 9.0, 9.0]},
         {"decode.bases": 9, "decode.cells": 9}),
    Call(101.0, {"advntr.model.bank_read": [4, 0.2, 0.2],
                 "advntr.model.build": [1, 0.4, 0.1],
                 "advntr.model.bank_write": [1, 0.08, 0.08],
                 "advntr.recruit": [1, 3.0, 2.0]},
         {"decode.bases": 300, "decode.cells": 1000}),
    Call(105.0, {"advntr.model.bank_read": [2, 0.1, 0.1]},
         {"decode.bases": 100, "decode.cells": 1000}),
]
WANT = {"bank_read_ms_per_locus": 75.0, "model_build_ms_per_locus": 100.0,
        "bank_write_ms_per_locus": 20.0, "recruit_parse_share": 20.0,
        "batch_fill": 20.0}


def _ctx(loci=4):
    return {"spans": {}, "t0": 100.0, "t_end": 110.0, "loci": loci,
            "trace": None, "work": {}}


def test_every_program_metric_is_checked_here():
    assert sorted(m["name"] for m in PROGRAM) == sorted(WANT)


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_on_a_synthetic_window(name, monkeypatch):
    from advntr_tpu_torch.utils import profiler
    monkeypatch.setattr(profiler, "finished_calls", lambda: list(CALLS))
    mod = importlib.import_module(f"portbench.metrics.{name}")
    assert mod.read(_ctx()) == pytest.approx(WANT[name])
    assert mod.read(_ctx(loci=0)) is None
    monkeypatch.setattr(profiler, "finished_calls", lambda: CALLS[:1])
    assert mod.read(_ctx()) is None


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_of_a_program_without_totals(name, monkeypatch):
    """A port that keeps no per-call totals (the one before them) gives
    nothing to read, and no error."""
    from advntr_tpu_torch.utils import profiler
    monkeypatch.delattr(profiler, "finished_calls")
    mod = importlib.import_module(f"portbench.metrics.{name}")
    assert mod.read(_ctx()) is None


def test_totals_sum_the_window_calls(monkeypatch):
    from advntr_tpu_torch.utils import profiler
    monkeypatch.setattr(profiler, "finished_calls", lambda: list(CALLS))
    t = _program.totals(_ctx())
    assert t["spans"]["advntr.model.bank_read"] == [6, pytest.approx(0.3),
                                                    pytest.approx(0.3)]
    assert t["counters"] == {"decode.bases": 400, "decode.cells": 2000}


def _tiny(cell):
    spec = copy.deepcopy(harness.load_cell(cell, MANIFEST))
    cfg, tr = spec["config"], spec["traffic"]
    if cfg["platform"] == "illumina":
        cfg["panel"]["loci"] = 10
        tr["reads"]["coverage"] = 6
        tr.update(loci_per_call=10, warmup_loci=1, check_loci=3)
    else:
        cfg["panel"].update(loci=2, long_every=0, max_tract_bp=150,
                            context_bp=600)
        tr["reads"].update(read_length=1500, coverage=6)
        tr.update(loci_per_call=2, check_loci=2)
    spec["config_bytes"] = json.dumps(cfg).encode()
    return spec


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_traced_run_reports_the_program_metrics(cell, tmp_path,
                                                monkeypatch):
    """A ``--trace 1`` run of the cell on the CPU reports each program
    metric its entry lists, read from the window's call alone."""
    monkeypatch.chdir(tmp_path)
    # a bank of its own: the other cells' tests may build theirs at once
    monkeypatch.setattr(harness, "_bank_dir", lambda spec: tmp_path / "bank")
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        code, result = harness.execute(_tiny(cell), 2 ** 31 + 9, 0.01, True,
                                       device="cpu",
                                       t_process=time.perf_counter())
    finally:
        torch.set_num_threads(saved)
    assert code == 0 and result["correct"], result["checks"]
    listed = {m["name"] for m in PROGRAM if cell in m["workloads"]}
    assert listed and listed <= set(result["metrics"])
    for name in listed:
        value = result["metrics"][name]["value"]
        assert value > 0, name
        if name.endswith(("_share", "_fill")):
            assert value <= 100, name


# ---- idle time by span ----------------------------------------------------

def _x(name, ts, dur, cat):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat}


EVENTS = [
    _x("portbench.traced", 0, 100, "user_annotation"),
    _x("k1", 10, 10, "kernel"), _x("copy", 50, 10, "gpu_memcpy"),
    _x("late", 150, 10, "kernel"),
    _x("advntr.call", 0, 100, "user_annotation"),
    _x("advntr.recruit", 5, 35, "user_annotation"),
    _x("advntr.recruit.filter", 8, 17, "user_annotation"),
    _x("advntr.x", 30, 0, "user_annotation"),
    _x("advntr.model", 45, 45, "user_annotation"),
    _x("advntr.model.bank_read", 61, 9, "user_annotation"),
    _x("model", 0, 100, "user_annotation"),
]


def test_idle_by_span_on_a_synthetic_trace(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": EVENTS}))
    got = idle.idle_by_span(str(path))
    want = {"advntr.call": 20, "advntr.recruit": 18,
            "advntr.recruit.filter": 7, "advntr.model": 26,
            "advntr.model.bank_read": 9}
    assert set(got) == set(want)
    for name, us in want.items():
        assert got[name] == pytest.approx(us * 1e-6), name
    assert idle.shallow_share(got) == pytest.approx(25.0)


def test_idle_by_span_without_spans_or_device():
    bare = [e for e in EVENTS if not e["name"].startswith("advntr.")]
    got = idle.reduce_events(bare)
    assert got == {"": pytest.approx(80e-6)}
    assert idle.shallow_share(got) == pytest.approx(100.0)
    assert idle.reduce_events([e for e in EVENTS
                               if e["cat"] == "user_annotation"]) is None
    assert idle.reduce_events(EVENTS[1:]) is None
