"""The port's spans and counters (``utils/profiler.py``) on the CPU: nesting,
parents, call ids and self times on a toy tree; nothing kept and no
profiler range opened while records are off; counters; and whole genotype
calls: the same output with records and ranges on as off, every span of
the Illumina and long-read paths inside its parent, a bank hit read and
not built, and the decode counters equal to the launched batches'
shapes."""

import json
import os
import shutil

import pytest
import torch

from advntr_tpu_torch import cli
from advntr_tpu_torch.engine import device_analytics as da
from advntr_tpu_torch.engine import finder as finder_mod
from advntr_tpu_torch.synthetic import write_cstb_sample, write_pacbio_panel
from advntr_tpu_torch.utils import profiler

# the suite runs test files in parallel worker processes: one torch thread
# each keeps them from oversubscribing the cores
torch.set_num_threads(1)

# the harness's layer names (portbench/spans.py), which no span may take
HARNESS_LAYERS = {"recruit", "model", "decode", "engine", "align"}

# each span of the genotype paths and the span it opens inside
PARENT = {
    "advntr.recruit": "advntr.call",
    "advntr.recruit.filter": "advntr.recruit",
    "advntr.recruit.drain": "advntr.recruit",
    "advntr.engine.mapped": "advntr.call",
    "advntr.engine.prepare": "advntr.call",
    "advntr.model": "advntr.call",
    "advntr.model.pool_wait": "advntr.model",
    "advntr.model.bank_read": "advntr.model",
    "advntr.model.build": "advntr.model",
    "advntr.model.build.profile": "advntr.model.build",
    "advntr.model.build.graph": "advntr.model.build",
    "advntr.model.build.compile": "advntr.model.build",
    "advntr.model.build.struct": "advntr.model.build",
    "advntr.model.bank_write": "advntr.model",
    "advntr.model.pad": "advntr.model",
    "advntr.model.upload": "advntr.model",
    "advntr.decode.stack": "advntr.call",
    "advntr.decode.launch": "advntr.call",
    "advntr.decode.wait": "advntr.call",
    "advntr.decode.gates": "advntr.call",
}
# the long-read path: one locus a span, each read scored inside it
LONG_PARENT = dict(PARENT, **{
    "advntr.locus": "advntr.call",
    "advntr.engine.windows": "advntr.locus",
    "advntr.anchor": "advntr.engine.windows",
    "advntr.model": "advntr.locus",
    "advntr.score": "advntr.locus",
    "advntr.engine.prepare": "advntr.score",
    "advntr.decode.stack": "advntr.score",
    "advntr.decode.launch": "advntr.score",
    "advntr.decode.wait": "advntr.score",
})
BUILD = {"advntr.model.build", "advntr.model.build.profile",
         "advntr.model.build.graph", "advntr.model.build.compile",
         "advntr.model.build.struct"}


@pytest.fixture(autouse=True)
def _fresh():
    profiler.disable()
    profiler.reset()
    yield
    profiler.disable()
    profiler.reset()


def _ticking(monkeypatch, times):
    ticks = iter(times)
    monkeypatch.setattr(profiler, "_clock", lambda: next(ticks))


def test_toy_tree_nesting_parents_call_ids_and_self_times(monkeypatch):
    profiler.enable(records=True)
    _ticking(monkeypatch, [0.0, 1.0, 2.0, 4.0, 6.0, 7.0, 9.0, 10.0,
                           20.0, 20.5, 21.5, 21.5, 22.5, 23.0, 30.0, 31.0])
    with profiler.span(profiler.CALL):
        with profiler.span("advntr.a", vid=7):
            with profiler.span("advntr.b", reads=3):
                pass
        with profiler.span("advntr.c"):
            pass
    with profiler.span(profiler.CALL):
        with profiler.span("advntr.c"):
            pass
        with profiler.span("advntr.c"):
            pass
    with profiler.span("advntr.d"):
        pass
    recs = {(r.call, r.name): r for r in profiler.records()}
    first, second = profiler.finished_calls()
    assert first.call != second.call
    assert (first.t0, first.t1) == (0.0, 10.0)
    assert first.spans == {"advntr.call": [1, 10.0, 3.0],
                           "advntr.a": [1, 5.0, 3.0],
                           "advntr.b": [1, 2.0, 2.0],
                           "advntr.c": [1, 2.0, 2.0]}
    assert second.spans == {"advntr.call": [1, 3.0, 1.0],
                            "advntr.c": [2, 2.0, 2.0]}
    assert profiler.ambient().spans == {"advntr.d": [1, 1.0, 1.0]}
    call = recs[(first.call, "advntr.call")]
    a, b = recs[(first.call, "advntr.a")], recs[(first.call, "advntr.b")]
    c = recs[(first.call, "advntr.c")]
    assert call.parent is None and a.parent == call.id == c.parent
    assert b.parent == a.id and (b.t0, b.t1) == (2.0, 4.0)
    assert (a.vid, b.vid, c.vid) == (7, 7, None)
    assert b.attrs == {"reads": 3}
    assert recs[(None, "advntr.d")].parent is None
    assert profiler.stage_summary(first).splitlines()[:2] == [
        f"stage timing (call {first.call}, 10.000s):",
        "  advntr.call: 10.000s over 1 spans, self 3.000s"]


def test_decorator_form_and_names():
    @profiler.span("advntr.twice")
    def twice(x):
        return 2 * x

    with profiler.span(profiler.CALL):
        assert twice(3) == 6 and twice(4) == 8
    assert twice.__name__ == "twice"
    assert profiler.finished_calls()[-1].spans["advntr.twice"][0] == 2
    for bad in sorted(HARNESS_LAYERS) + ["call", "portbench.traced"]:
        with pytest.raises(ValueError):
            profiler.span(bad)


def test_off_keeps_no_record_and_opens_no_range(monkeypatch):
    opened = []

    class Range:
        def __init__(self, name):
            opened.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "record_function", Range)
    with profiler.span(profiler.CALL):
        with profiler.span("advntr.a"):
            pass
    assert profiler.records() == [] and opened == []
    assert profiler.finished_calls()[-1].spans["advntr.a"][0] == 1
    profiler.enable(records=False, annotate=True)
    with profiler.span(profiler.CALL):
        with profiler.span("advntr.a"):
            pass
    assert opened == ["advntr.call", "advntr.a"]
    assert profiler.records() == []
    profiler.disable()
    with profiler.span("advntr.a"):
        pass
    assert len(opened) == 2


def test_counters_go_to_the_innermost_call():
    profiler.count("decode.rows", 5)
    with profiler.span(profiler.CALL):
        profiler.count("decode.rows", 2)
        with profiler.span("advntr.a"):
            profiler.count("decode.rows", 3)
            profiler.count("model.hit")
    assert profiler.finished_calls()[-1].counters == {"decode.rows": 5,
                                                      "model.hit": 1}
    assert profiler.ambient().counters == {"decode.rows": 5}
    summary = profiler.stage_summary()
    assert "  decode.rows: 5" in summary and "  model.hit: 1" in summary
    profiler.reset()
    assert profiler.finished_calls() == [] and \
        profiler.ambient().counters == {}


def test_errors_close_their_spans():
    with pytest.raises(KeyError):
        with profiler.span(profiler.CALL):
            with profiler.span("advntr.a"):
                raise KeyError("x")
    t = profiler.finished_calls()[-1]
    assert t.spans["advntr.a"][0] == 1 and t.t1 is not None
    with profiler.span("advntr.b"):
        pass
    assert profiler.ambient().spans["advntr.b"][0] == 1


def test_names_in_a_cpu_profiler_trace(tmp_path):
    from torch.profiler import ProfilerActivity, profile
    profiler.enable(records=True, annotate=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiler.span(profiler.CALL):
            with profiler.span("advntr.model"):
                torch.ones(4).add_(1)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"advntr.call", "advntr.model"} <= names


# ---- whole genotype calls -----------------------------------------------

@pytest.fixture(scope="module")
def cstb(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tracing_cstb")
    db, bam = write_cstb_sample(str(tmp))
    return tmp, db, bam


def _genotype(argv_in, wd, extra=()):
    os.makedirs(wd, exist_ok=True)
    out = os.path.join(wd, "out")
    cli.main(["genotype"] + argv_in + ["--working_directory", str(wd),
                                       "--disable_logging", "-o", out,
                                       "--device", "cpu"] + list(extra))
    with open(out, "rb") as fh:
        return fh.read()


def _held_to(parents, records):
    """Every record inside its parent, the parent of the name it should
    have, in the same call."""
    by_id = {r.id: r for r in records}
    for r in records:
        assert r.name.startswith("advntr.")
        if r.name == profiler.CALL:
            assert r.parent is None
            continue
        p = by_id[r.parent]
        assert p.name == parents[r.name], (r.name, p.name)
        assert p.t0 <= r.t0 <= r.t1 <= p.t1 and p.call == r.call


def _launches(monkeypatch):
    shapes = []
    grouped = da.read_stats_grouped

    def spy(models, seqs, lengths, *a, **k):
        shapes.append(tuple(seqs.shape))
        return grouped(models, seqs, lengths, *a, **k)
    monkeypatch.setattr(da, "read_stats_grouped", spy)
    return shapes


def test_illumina_spans_counters_and_output(cstb, monkeypatch):
    tmp, db, bam = cstb
    argv = ["-a", bam, "-m", db]
    plain = _genotype(argv, tmp / "plain")
    profiler.reset()
    profiler.enable(records=True, annotate=True)
    shapes = _launches(monkeypatch)
    traced = _genotype(argv, tmp / "built")
    assert traced == plain and plain.split() == [b"301645", b"2/5"]
    built = profiler.records()
    _held_to(PARENT, built)
    want = set(PARENT) - {"advntr.model.pool_wait",
                          "advntr.model.bank_read"} | {profiler.CALL}
    assert {r.name for r in built} == want
    calls = profiler.finished_calls()
    t = calls[-1]
    assert t.counters["decode.rows_padded"] == sum(g * b for g, b, _
                                                   in shapes)
    assert t.counters["decode.cells"] == sum(g * b * n for g, b, n
                                             in shapes)
    assert 0 < t.counters["decode.rows"] <= t.counters["decode.rows_padded"]
    assert 0 < t.counters["decode.bases"] <= t.counters["decode.cells"]
    assert t.counters["model.built"] == 1 and "model.bank_hit" not in \
        t.counters
    assert t.counters["recruit.hits"] <= t.counters["recruit.reads"]
    # a BAM's unmapped reads all come through the bulk scan
    assert t.counters["recruit.scan_unmapped"] == t.counters["recruit.reads"]
    assert t.counters["recruit.scan_records"] >= t.counters["recruit.reads"]
    assert t.counters["mapped.kept"] <= t.counters["mapped.fetched"]
    # a bank hit: read, not built
    profiler.enable(records=True)
    wd = tmp / "bank"
    os.makedirs(wd)
    shutil.copytree(tmp / "built" / "model_bank", wd / "model_bank")
    assert _genotype(argv, wd) == plain
    hit = profiler.records()
    _held_to(PARENT, hit)
    names = {r.name for r in hit}
    assert "advntr.model.bank_read" in names and not names & BUILD
    assert "advntr.model.bank_write" not in names
    assert profiler.finished_calls()[-1].counters["model.bank_hit"] == 1
    # the model-building pool: the build is waited for, in the worker's process
    profiler.enable(records=True)
    assert _genotype(argv, tmp / "pool", ["-t", "2"]) == plain
    pooled = profiler.records()
    _held_to(PARENT, pooled)
    names = {r.name for r in pooled}
    assert "advntr.model.pool_wait" in names and not names & BUILD
    assert profiler.finished_calls()[-1].counters["model.pool_hit"] == 1
    # off: the same text, the same totals' names
    profiler.disable()
    assert _genotype(argv, tmp / "off") == plain
    assert profiler.records() == []
    assert set(profiler.finished_calls()[-1].spans) == want


def test_long_read_spans(tmp_path, monkeypatch):
    db, fa, truth, _ = write_pacbio_panel(str(tmp_path), n_loci=2,
                                          coverage=6, long_locus=None)
    argv = ["-p", "-f", fa, "-m", db]
    plain = _genotype(argv, tmp_path / "plain")
    profiler.enable(records=True, annotate=True)
    assert _genotype(argv, tmp_path / "traced") == plain
    recs = profiler.records()
    _held_to(LONG_PARENT, recs)
    names = {r.name for r in recs}
    assert BUILD | {"advntr.model.bank_write", "advntr.engine.windows",
                    "advntr.anchor", "advntr.locus", "advntr.score",
                    "advntr.recruit.filter"} <= names
    loci = {r.vid for r in recs if r.name == "advntr.locus"}
    assert loci == set(truth)
    assert {r.vid for r in recs if r.name in BUILD} <= loci
    t = profiler.finished_calls()[-1]
    assert t.counters["model.built"] == 2
    assert t.counters["decode.rows"] <= t.counters["decode.rows_padded"]
    # reads from a FASTA file: no BAM scan
    assert t.counters["recruit.reads"] > 0
    assert "recruit.scan_records" not in t.counters
    assert "recruit.scan_unmapped" not in t.counters


def test_no_old_stage_api():
    for name in ("time_usage", "STAGE_TOTALS", "STAGE_COUNTS",
                 "device_trace"):
        assert not hasattr(profiler, name)
    assert finder_mod.LocusModelCache.get.__name__ == "get"
