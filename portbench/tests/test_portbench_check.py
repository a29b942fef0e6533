"""What decides ``correct``, on the CPU at a tiny size: a whole run of each
cell (the harness's look for a chip skipped, the port's plain PyTorch path
in the card's place) agrees with the plain reference; the same run with
the timed path broken underneath reads ``correct: false``; and the
control, the reference one precision below float32, fails the check."""

import copy
import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import control, harness

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())


def tiny_spec(cell: str) -> dict:
    spec = copy.deepcopy(harness.load_cell(cell, MANIFEST))
    cfg, tr = spec["config"], spec["traffic"]
    if cfg["platform"] == "illumina":
        cfg["panel"]["loci"] = 10
        tr["reads"]["coverage"] = 6
        tr["loci_per_call"] = 10
        tr["warmup_loci"] = 1
        tr["check_loci"] = 3
    else:
        cfg["panel"].update(loci=2, long_every=0, max_tract_bp=150,
                            context_bp=600)
        tr["reads"].update(read_length=1500, coverage=6)
        tr["loci_per_call"] = 2
        tr["check_loci"] = 2
    spec["config_bytes"] = json.dumps(cfg).encode()
    return spec


def run(spec, seed=2 ** 31 + 5):
    code, result = harness.execute(spec, seed, 0.01, False, device="cpu",
                                   t_process=time.perf_counter())
    assert code == 0
    return result


CELLS = [w["name"] for w in MANIFEST["workloads"]]


@pytest.fixture(autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    result = run(tiny_spec(cell))
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {"loci_per_s", "setup_s"}
    assert result["checks"]["logp_gap"]["value"] < 1e-4


def _half_batch(stats_fn):
    """Score the first half of the rows; the rest copy the first half's
    statistics (half the batch left out)."""
    def fault(*args, **kwargs):
        out = stats_fn(*args, **kwargs)
        fixed = {}
        for k, v in out.items():
            v = v.clone() if hasattr(v, "clone") else np.array(v)
            n = v.shape[-1]
            h = max(1, n // 2)
            v[..., h:] = v[..., :1]
            fixed[k] = v
        return fixed
    return fault


def _shift_call(fn):
    def fault(*args, **kwargs):
        out = fn(*args, **kwargs)
        if isinstance(out, tuple):
            pair, p = out
            return (None if pair is None else
                    tuple(c + 1 for c in pair)), p
        if out.copy_numbers is not None:
            out.copy_numbers = tuple(c + 1 for c in out.copy_numbers)
        return out
    return fault


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["half_batch", "answer_altered"])
def test_broken_timed_path_is_not_correct(cell, fault, tmp_path,
                                          monkeypatch):
    monkeypatch.chdir(tmp_path)
    from advntr_tpu_torch.engine import device_analytics as da
    from advntr_tpu_torch.engine import finder
    spec = tiny_spec(cell)
    short = spec["config"]["platform"] == "illumina"
    if fault == "half_batch":
        if short:
            monkeypatch.setattr(da, "read_stats_grouped",
                                _half_batch(da.read_stats_grouped))
        else:
            monkeypatch.setattr(finder.VNTRFinder, "run_device",
                                _half_batch(finder.VNTRFinder.run_device))
    elif short:
        monkeypatch.setattr(finder.VNTRFinder, "genotype_from_counts",
                            _shift_call(finder.VNTRFinder.genotype_from_counts))
    else:
        monkeypatch.setattr(finder, "find_genotype",
                            _shift_call(finder.find_genotype))
    result = run(spec)
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_float32_passes(cell):
    spec = tiny_spec(cell)
    limits = spec["workload"]["limits"]
    low = control.control_numbers(spec, 11, torch.bfloat16, "cpu")
    assert any(low[k] > lim for k, lim in limits.items()), low
    f32 = control.control_numbers(spec, 11, torch.float32, "cpu")
    assert all(f32[k] <= lim for k, lim in limits.items()), f32


@pytest.mark.cuda
def test_run_on_the_card():
    """The cell's run on a CUDA device (chip only)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the run's kernels are CUDA C++")
    spec = tiny_spec(CELLS[0])
    code, result = harness.execute(spec, 3, 0.01, True, device="cuda",
                                   t_process=time.perf_counter())
    assert code == 0 and result["correct"]


@pytest.mark.parametrize("cell", [c for c in CELLS if harness.load_cell(
    c, MANIFEST)["config"]["platform"] == "illumina"])
def test_mapped_candidates_dropped_is_not_correct(cell, tmp_path,
                                                  monkeypatch):
    """The aligned reads over a locus left out of the timed path."""
    monkeypatch.chdir(tmp_path)
    from advntr_tpu_torch.engine import analyzer
    monkeypatch.setattr(analyzer.GenomeAnalyzer, "mapped_candidates",
                        lambda self, bam, finder, read_length: [])
    result = run(tiny_spec(cell))
    assert result["correct"] is False, result["checks"]
    assert result["checks"]["recruit_diff"]["value"] > 0


def test_each_function_wrapped_once_and_results_untouched():
    from advntr_tpu_torch.engine import analyzer
    from portbench import spans
    rec = spans.Recorder()
    seen = []
    rec.hook("advntr_tpu_torch.engine.finder", "VNTRFinder.score_reads",
             before=lambda args: None, after=lambda args, out: None)
    origs = {(m, p): spans._resolve(m, p) for layer in spans.LAYERS.values()
             for m, p in layer}
    origs = {k: getattr(o, a) for k, (o, a) in origs.items()}
    assert rec.install() == []
    try:
        for (m, p), orig in origs.items():
            owner, attr = spans._resolve(m, p)
            assert getattr(owner, attr).__wrapped__ is orig
        sentinel = object()
        fn = rec._wrapper(lambda *a: sentinel, "decode",
                          [lambda args: seen.append("before")],
                          [lambda args, out: seen.append(out)])
        assert fn() is sentinel and rec.spans["decode"]
        assert seen == ["before", sentinel]
    finally:
        rec.uninstall()
    for (m, p), orig in origs.items():
        owner, attr = spans._resolve(m, p)
        assert getattr(owner, attr) is orig
    assert analyzer.GenomeAnalyzer._dispatch_group is \
        origs[("advntr_tpu_torch.engine.analyzer",
               "GenomeAnalyzer._dispatch_group")]
