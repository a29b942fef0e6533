"""The cold Illumina deployment on the CPU at a tiny size: a panel of 17
loci (above 16, so the grouped path floors its batches at 512 rows)
genotyped in a working directory that holds no models, so that every model
is built inside the call, against the same call from a bank that
``buildbank`` made; the counters of what the builds make and hold
(``model.build_states``, ``model.build_dense_bytes``); the benchmark cell
``ill6719.wgs30.built`` through the harness against the plain reference;
and the reader of ``build_us_per_state``."""

import copy
import json
import os
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from advntr_tpu_torch import cli
from advntr_tpu_torch.engine import finder
from advntr_tpu_torch.models import bank
from advntr_tpu_torch.utils import profiler
from portbench import generate, harness
from portbench.metrics import build_us_per_state

# the suite runs test files in parallel worker processes: one torch thread
# each keeps them from oversubscribing the cores
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL = "ill6719.wgs30.built"
LOCI = 17
READ_LENGTH = 60
# the artifact's O(n^2) tables, named here apart from bank.DENSE_FIELDS
DENSE = ("log_T", "t_unit_starts", "t_unit_ends", "hop_choice",
         "closure_parent")


def tiny_spec() -> dict:
    """The cell's own files at a tiny size: 17 loci, 60 bp reads at
    coverage 6, tracts up to 40 bp."""
    spec = copy.deepcopy(harness.load_cell(CELL, MANIFEST))
    cfg, tr = spec["config"], spec["traffic"]
    cfg["panel"].update(loci=LOCI, flank=80, read_length=READ_LENGTH,
                        max_tract_bp=40)
    tr["reads"].update(read_length=READ_LENGTH, coverage=6)
    tr.update(loci_per_call=LOCI, warmup_loci=1, check_loci=3)
    spec["config_bytes"] = json.dumps(cfg).encode()
    return spec


def _genotype(db, bam, workdir, seen):
    """One genotype call; its calls, and its totals.  ``seen`` collects
    each locus's candidates, rows and per-read statistics."""
    out = os.path.join(workdir, "out.txt")
    orig = finder.VNTRFinder.counts_from_stats

    def capture(self, reads, row_info, stats, *args, **kwargs):
        R = len(row_info)
        seen[self.reference_vntr.id] = (
            [(r[0], bool(r[2])) for r in reads], [tuple(x) for x in row_info],
            {k: np.array(stats[k][:R]) for k in harness.STAT_KEYS})
        return orig(self, reads, row_info, stats, *args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(finder.VNTRFinder, "counts_from_stats", capture)
        cli.main(["genotype", "-a", bam, "-m", db, "--working_directory",
                  str(workdir), "-o", out, "--device", "cpu"])
    lines = Path(out).read_text().splitlines()
    return dict(zip(lines[0::2], lines[1::2])), profiler.finished_calls()[-1]


@pytest.fixture(scope="module")
def calls(tmp_path_factory):
    """The tiny panel genotyped cold (an empty working directory) and
    warm (a bank that ``buildbank`` made), with every artifact the cold
    call built."""
    tmp = tmp_path_factory.mktemp("cold_panel")
    spec = tiny_spec()
    loci = generate.make_panel(spec["config"])
    db, bam = str(tmp / "panel.db"), str(tmp / "sample.bam")
    generate.write_db(db, loci)
    reads, _, placed = generate.make_sample(loci, spec["traffic"], 11, 0,
                                            LOCI / 6719)
    generate.write_bam(bam, reads, placed, mapq=60)
    built = []
    orig = bank.build_locus_payload

    def keep(*args):
        payload = orig(*args)
        built.append(payload[0])
        return payload

    cold, warm = {}, {}
    os.makedirs(tmp / "cold")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bank, "build_locus_payload", keep)
        cold_text, cold_totals = _genotype(db, bam, tmp / "cold", cold)
    cli.main(["buildbank", "-m", db, "--working_directory",
              str(tmp / "warm"), "-l", str(READ_LENGTH), "-t", "1"])
    warm_text, warm_totals = _genotype(db, bam, tmp / "warm", warm)
    return dict(cold=(cold_text, cold_totals.counters, cold),
                warm=(warm_text, warm_totals.counters, warm),
                cold_totals=cold_totals, built=built,
                vids=[str(lc.vid) for lc in loci])


def test_cold_call_equals_the_call_from_a_bank(calls):
    cold_text, _, cold = calls["cold"]
    warm_text, _, warm = calls["warm"]
    assert sorted(cold_text) == sorted(calls["vids"])
    assert cold_text == warm_text
    assert sorted(cold) == sorted(warm) and len(cold) == LOCI
    for vid in cold:
        (c_reads, c_rows, c_stats), (w_reads, w_rows, w_stats) = \
            cold[vid], warm[vid]
        assert c_reads == w_reads and c_rows == w_rows, vid
        for k in harness.STAT_KEYS:
            np.testing.assert_array_equal(c_stats[k], w_stats[k],
                                          err_msg=f"{vid} {k}")


def test_cold_call_builds_every_model_and_the_warm_one_none(calls):
    _, cold, _ = calls["cold"]
    _, warm, _ = calls["warm"]
    assert cold["model.built"] == LOCI and "model.bank_hit" not in cold
    assert warm["model.bank_hit"] == LOCI and "model.built" not in warm
    assert "model.pool_hit" not in cold       # -t 1: no builder pool


def test_build_counters_are_the_sums_over_the_built_artifacts(calls):
    _, cold, _ = calls["cold"]
    _, warm, _ = calls["warm"]
    built = calls["built"]
    assert len(built) == LOCI
    assert cold["model.build_states"] == sum(len(a.names) for a in built)
    assert cold["model.build_dense_bytes"] == sum(
        getattr(a, f).nbytes for a in built for f in DENSE)
    assert "model.build_states" not in warm
    assert "model.build_dense_bytes" not in warm
    summary = profiler.stage_summary(calls["cold_totals"])
    assert f"model.build_states: {cold['model.build_states']}" in summary
    assert f"model.build_dense_bytes: {cold['model.build_dense_bytes']}" \
        in summary


def _roll_an_emission_row(build):
    """The build with one emission row of the first repeat unit's first
    match column shifted by a base."""
    def altered(*args):
        art, sm = build(*args)
        sm.eM[sm.W_s] = np.roll(sm.eM[sm.W_s], 1)
        return art, sm
    return altered


@pytest.mark.parametrize("build", ["sound", "emission_row_altered"])
def test_cell_run_against_the_reference(build, tmp_path, monkeypatch):
    """A whole run of the cell's files (the port's plain PyTorch path in
    the card's place) is correct against ``portbench/reference/``, its
    timed call building every model; with the build altered underneath it
    is not."""
    monkeypatch.chdir(tmp_path)
    # the tests' conftest loads JAX for the reference comparisons: the
    # harness's own check for it concerns the benchmark's process
    monkeypatch.setattr(harness, "forbidden_modules", lambda: [])
    if build != "sound":
        monkeypatch.setattr(bank, "build_locus_payload",
                            _roll_an_emission_row(bank.build_locus_payload))
    code, result = harness.execute(tiny_spec(), 2 ** 31 + 77, 0.01, False,
                                   device="cpu",
                                   t_process=time.perf_counter())
    assert code == 0 and result["attempted"] == LOCI
    timed = profiler.finished_calls()[-1].counters
    assert timed["model.built"] == LOCI and "model.bank_hit" not in timed
    if build == "sound":
        assert result["correct"] is True, result["checks"]
        assert result["failed"] == 0
    else:
        assert result["correct"] is False, result["checks"]
        assert result["checks"]["logp_gap"]["value"] > 1e-4


class _Call:
    def __init__(self, t0, spans, counters):
        self.call, self.t0, self.t1 = 1, t0, t0 + 1.0
        self.spans, self.counters = spans, counters


def _ctx():
    return {"spans": {}, "t0": 100.0, "t_end": 110.0, "loci": 4,
            "trace": None, "work": {}}


BUILD = {"advntr.model.build": [2, 0.3, 0.01]}


@pytest.mark.parametrize("calls_in_window, want", [
    ([_Call(101.0, BUILD, {"model.build_states": 1500}),
      _Call(105.0, {"advntr.model.build": [1, 0.15, 0.0]},
            {"model.build_states": 750}),
      _Call(50.0, BUILD, {"model.build_states": 1})], 200.0),
    ([_Call(101.0, BUILD, {"model.built": 2})], None),
    ([_Call(101.0, {"advntr.model.bank_read": [2, 0.1, 0.1]},
            {"model.bank_hit": 2})], None),
    ([], None),
], ids=["known_totals", "no_counter", "bank_call", "no_call"])
def test_build_us_per_state_reader(calls_in_window, want, monkeypatch):
    monkeypatch.setattr(profiler, "finished_calls",
                        lambda: list(calls_in_window))
    got = build_us_per_state.read(_ctx())
    assert got == (None if want is None else pytest.approx(want))


def test_build_us_per_state_of_a_program_without_totals(monkeypatch):
    monkeypatch.delattr(profiler, "finished_calls")
    assert build_us_per_state.read(_ctx()) is None
