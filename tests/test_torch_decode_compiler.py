"""The decode-only model compile (``models/decode_compiler.py``) and the
builds that take it.

``compile_decode`` against ``compile_graph`` on the cold Illumina panel's
loci (one of each motif length), long-read models (a short tract, and the
panel's long tract cut to fewer copies), the CSTB model, a soak model with
substituted units and an imported topology (the refused one, through the
trained-HMM JSON): every field equal (``np.array_equal``, -inf included,
same dtype), the dense tables None, on the native loops and on the NumPy
fallback alike; and neither path holding anything near an (n_e x n_s)
table.  Then the model cache: a build for the default decode compiles
the decode payload alone (``model.build_decode_only``, no dense bytes
held), its dense tables fill from ``DenseSource`` equal to
``compile_graph``'s, and the ``struct`` decoder and the modes that read
paths (``-fs``, ``-u``) build whole and rebuild nothing."""

import contextlib
import dataclasses
import functools
import json
import os
import random
import tracemalloc
from pathlib import Path

import numpy as np
import pytest
import torch

from advntr_tpu_torch import cli
from advntr_tpu_torch.engine import finder
from advntr_tpu_torch.engine.locus_model import LocusModelCache
from advntr_tpu_torch.models import bank, decode_compiler
from advntr_tpu_torch.models.compiler import ModelArtifact, compile_graph
from advntr_tpu_torch.models.decode_compiler import compile_decode
from advntr_tpu_torch.models.hmm_json import (graph_from_pomegranate_json,
                                              graph_to_pomegranate_json)
from advntr_tpu_torch.models.reference_vntr import ReferenceVNTR
from advntr_tpu_torch.synthetic import (CSTB_PATTERN, build_cstb_locus,
                                        rand_seq, refused_topology,
                                        soak_model, write_cstb_sample,
                                        write_frameshift_sample)
from advntr_tpu_torch.utils import profiler
from portbench import generate

# the suite runs test files in parallel worker processes: one torch thread
# each keeps them from oversubscribing the cores
torch.set_num_threads(1)

CONFIGS = Path(__file__).resolve().parents[1] / "portbench" / "configs"
COLD_MOTIFS = (8, 10, 12, 15, 20, 24)
MODELS = ([f"cold_{m}bp" for m in COLD_MOTIFS] +
          ["long_short_tract", "long_tract_cut", "cstb", "soak",
           "imported_refused"])


def _panel(config: str, loci: int):
    cfg = json.loads((CONFIGS / f"{config}.json").read_text())
    cfg["panel"]["loci"] = loci
    out = []
    for lc in generate.make_panel(cfg):
        ref = ReferenceVNTR(lc.vid, lc.pattern, lc.start, "chr1")
        ref.repeat_segments = [lc.pattern] * lc.ref_copies
        ref.left_flanking_region, ref.right_flanking_region = \
            lc.left, lc.right
        out.append((ref, lc, cfg))
    return out


@functools.lru_cache(maxsize=None)
def _graph(name: str):
    if name.startswith("cold_"):
        motif = int(name[5:-2])
        ref, _, cfg = next(x for x in _panel("illumina_hg19_6719_cold", 64)
                           if len(x[0].pattern) == motif)
        return bank.read_matcher(*bank.model_key(ref, 150,
                                                 cfg["max_error_rate"]))
    if name.startswith("long_"):
        # the long-read panel's locus 1 (a 15 bp motif) with the copies of
        # its longer allele, and its long-tract locus 5 (a 30 bp motif)
        # cut from about 90 copies to 24, between 100 bp flanks
        panel = _panel("pacbio_hg19_8960", 6)
        ref, lc, cfg = panel[1] if name == "long_short_tract" else panel[5]
        copies = lc.allele_range[1] if name == "long_short_tract" else 24
        return bank.read_matcher(ref, copies, 100, cfg["max_error_rate"])
    if name == "cstb":
        return build_cstb_locus(150)[0]
    if name == "soak":
        return soak_model(random.Random(3), 0.05)[0]
    graph = build_cstb_locus(60)[0]
    return graph_from_pomegranate_json(json.loads(
        graph_to_pomegranate_json(refused_topology(graph))))


@functools.lru_cache(maxsize=None)
def _whole(name: str) -> ModelArtifact:
    return compile_graph(_graph(name))


@contextlib.contextmanager
def _path(path: str):
    """The native loops, or the NumPy fallback."""
    with pytest.MonkeyPatch.context() as mp:
        if path == "numpy":
            mp.setenv("ADVNTR_TPU_NO_NATIVE", "1")
            assert decode_compiler._native() is None
        else:
            mp.delenv("ADVNTR_TPU_NO_NATIVE", raising=False)
            assert decode_compiler._native() is not None
        yield


def _assert_decode_payload(got: ModelArtifact, whole: ModelArtifact):
    for f in dataclasses.fields(ModelArtifact):
        g, w = getattr(got, f.name), getattr(whole, f.name)
        if f.name in bank.DENSE_FIELDS:
            assert g is None, f.name
        elif isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, f.name
            assert np.array_equal(g, w), f.name
        else:
            assert type(g) is type(w) and g == w, f.name


@pytest.mark.parametrize("path", ["native", "numpy"])
@pytest.mark.parametrize("name", MODELS)
def test_decode_compile_equals_compile_graph(name, path):
    with _path(path):
        got = compile_decode(_graph(name))
    whole = _whole(name)
    _assert_decode_payload(got, whole)
    # what a bank file holds of the whole build
    _assert_decode_payload(got, bank.decode_payload(whole, None)[0])
    assert got.n_states == whole.n_states and got.n_silent == whole.n_silent
    assert np.isfinite(got.log_end).any() and np.isfinite(got.log_start).any()


@pytest.mark.parametrize("path", ["native", "numpy"])
def test_decode_compile_holds_no_closure_table(path):
    """The long model's compile peaks well under one float64 (n_e x n_s)
    table, which ``compile_graph`` makes several of."""
    g = _graph("long_tract_cut")
    whole = _whole("long_tract_cut")
    table = whole.n_states * whole.n_silent * 8
    with _path(path):
        compile_decode(g)       # the native library loaded outside
        tracemalloc.start()
        try:
            compile_decode(g)
            _, peak = tracemalloc.get_traced_memory()
        finally:
            tracemalloc.stop()
    assert whole.n_states > 1500 and peak < table / 2, (peak, table)


# ---- the model cache --------------------------------------------------------

READ_LEN = 60


def _ref():
    ref = ReferenceVNTR(301645, CSTB_PATTERN, 5000, "chr21", "CSTB",
                        "Promoter", 3)
    ref.repeat_segments = [CSTB_PATTERN] * 3
    ref.left_flanking_region = rand_seq(301645, 120)
    ref.right_flanking_region = rand_seq(301646, 120)
    return ref


def _finder(bank_dir):
    return finder.VNTRFinder(_ref(), model_cache=LocusModelCache(
        "cpu", bank_dir=str(bank_dir) if bank_dir else None))


@contextlib.contextmanager
def _call():
    """One genotype call's span; yields its counters."""
    with profiler.span(profiler.CALL) as call:
        yield call.totals.counters


@functools.lru_cache(maxsize=None)
def _locus_whole() -> ModelArtifact:
    vf = _finder(None)
    return compile_graph(bank.read_matcher(*vf.model_key(READ_LEN)))


@pytest.mark.parametrize("banked", [False, True], ids=["no_bank", "bank"])
def test_in_call_build_holds_the_decode_payload(tmp_path, banked):
    vf = _finder(tmp_path if banked else None)
    with _call() as counters:
        lm = vf.get_model(READ_LEN)
    _assert_decode_payload(lm.art, _locus_whole())
    assert counters["model.built"] == counters["model.build_decode_only"] \
        == 1
    assert counters["model.build_dense_bytes"] == 0
    assert counters["model.build_states"] == lm.art.n_states
    assert lm.source is not None
    # the bank holds the decode payload alone, no companion
    want = [os.path.basename(bank.bank_payload_path(
        str(tmp_path), 301645, *vf.model_key(READ_LEN)[1:]))]
    assert os.listdir(tmp_path) == (want if banked else [])


@pytest.mark.parametrize("banked", [False, True], ids=["no_bank", "bank"])
def test_dense_source_fills_compile_graph_tables(tmp_path, banked):
    """The dense tables of an in-call decode-only build, read by a mode,
    are ``compile_graph``'s: one rebuild, banked where there is a bank,
    and read once."""
    vf = _finder(tmp_path if banked else None)
    whole = _locus_whole()
    with _call() as counters:
        lm = vf.get_model(READ_LEN)
        art = lm.dense_art()
        assert lm.dense_art() is art
    for f in dataclasses.fields(ModelArtifact):
        np.testing.assert_array_equal(getattr(art, f.name),
                                      getattr(whole, f.name), f.name)
    assert counters["model.dense_rebuild"] == 1
    assert counters.get("model.dense_write", 0) == int(banked)
    assert not counters.get("model.dense_read")
    # a source over a bank's decode payload fills the same tables
    payload = bank.decode_payload(whole, None)[0]
    filled = bank.DenseSource((vf.reference_vntr,
                               *vf.model_key(READ_LEN)[1:]), None
                              ).fill(payload)
    for f in bank.DENSE_FIELDS:
        np.testing.assert_array_equal(getattr(filled, f),
                                      getattr(whole, f), f)


def test_struct_decoder_builds_whole(tmp_path, monkeypatch):
    """Under ``ADVNTR_TPU_KERNEL=struct`` every model's decoder reads its
    dense ``log_T``: the build keeps its tables and rebuilds nothing."""
    monkeypatch.setenv("ADVNTR_TPU_KERNEL", "struct")
    vf = _finder(tmp_path)
    with _call() as counters:
        lm = vf.get_model(READ_LEN)
        assert bank.has_dense_tables(lm.art)
        assert lm.struct_model() is not None
    assert counters["model.built"] == 1
    assert "model.build_decode_only" not in counters
    assert counters["model.build_dense_bytes"] == \
        bank.dense_bytes(_locus_whole()) > 0
    assert not counters.get("model.dense_rebuild")
    assert not counters.get("model.dense_read")
    for f in bank.DENSE_FIELDS:
        np.testing.assert_array_equal(getattr(lm.art, f),
                                      getattr(_locus_whole(), f), f)


@pytest.mark.parametrize("mode, whole", [
    ((), False), (("-fs",), True), (("-u",), True), (("-u", "--em"), False)],
    ids=["genotype", "frameshift", "update", "em_update"])
def test_modes_build_whole_only_where_they_read_paths(tmp_path, monkeypatch,
                                                      mode, whole):
    """A call builds its models whole where it reads every model's paths
    as text (``-fs``, ``-u``), and banks their dense tables with no
    rebuild; the default call and ``-u --em`` compile the decode payload
    alone."""
    if mode == ("-fs",):
        monkeypatch.setattr(finder.VNTRFinder, "find_frameshift",
                            functools.partialmethod(
                                finder.VNTRFinder.find_frameshift,
                                posterior=False))
        db, bam = write_frameshift_sample(str(tmp_path), 100, True)
    else:
        db, bam = write_cstb_sample(str(tmp_path), read_length=80,
                                    coverage=20)
    out = str(tmp_path / "out.txt")
    cli.main(["genotype", "-a", bam, "-m", db, "--working_directory",
              str(tmp_path), "--disable_logging", "-o", out, "--device",
              "cpu", *mode])
    lines = Path(out).read_text().splitlines()
    if mode == ("-fs",):
        assert lines[1].startswith("D")
    else:
        assert lines == ["301645", "2/5"]
    counters = profiler.finished_calls()[-1].counters
    assert counters["model.built"] == 1
    assert counters.get("model.build_decode_only", 0) == int(not whole)
    assert (counters["model.build_dense_bytes"] > 0) == whole
    assert not counters.get("model.dense_rebuild")
    assert counters.get("model.dense_write", 0) == int(whole)
