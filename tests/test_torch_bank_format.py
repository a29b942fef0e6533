"""The port's model bank format: a bank file holds the decode payload (the
artifact without its dense O(n^2) tables), the default decode reads
nothing more, and the modes that read the dense tables (the ``struct``
decoder, the path expansion of ``-fs`` and ``-u``) load them on demand:
from the companion file ``*.dense.pkl.gz`` where the bank has one, else by
rebuilding the locus.  ``buildbank`` writes both files."""

import contextlib
import dataclasses
import os

import numpy as np
import pytest
import torch

from advntr_tpu_torch import cli
from advntr_tpu_torch.engine import finder
from advntr_tpu_torch.engine.locus_model import LocusModelCache
from advntr_tpu_torch.models import bank
from advntr_tpu_torch.engine.simulate import simulate_diploid_reads
from advntr_tpu_torch.models.db import (create_vntrs_database,
                                        load_unique_vntrs_data,
                                        save_reference_vntr_to_database)
from advntr_tpu_torch.models.reference_vntr import ReferenceVNTR
from advntr_tpu_torch.ops.viterbi_struct import StructDeviceModel
from advntr_tpu_torch.synthetic import CSTB_PATTERN, rand_seq
from advntr_tpu_torch.utils import profiler

# the suite runs test files in parallel worker processes: one torch thread
# each keeps them from oversubscribing the cores
torch.set_num_threads(1)

READ_LEN = 60
DENSE_COUNTERS = ("model.dense_read", "model.dense_rebuild",
                  "model.dense_write")


def _ref(vid=301645, pattern=CSTB_PATTERN):
    ref = ReferenceVNTR(vid, pattern, 5000, "chr21", "CSTB", "Promoter", 3)
    ref.repeat_segments = [pattern] * 3
    ref.left_flanking_region = rand_seq(vid, 120)
    ref.right_flanking_region = rand_seq(vid + 1, 120)
    return ref


def _finder(bank_dir=None):
    return finder.VNTRFinder(_ref(), model_cache=LocusModelCache(
        "cpu", bank_dir=str(bank_dir) if bank_dir else None))


def _bank_path(vf, bank_dir):
    return bank.bank_payload_path(
        str(bank_dir), vf.reference_vntr.id,
        vf.get_copies_for_hmm(READ_LEN), READ_LEN,
        vf.config.max_error_rate)


@contextlib.contextmanager
def _call():
    """One genotype call's span; yields its counters."""
    with profiler.span(profiler.CALL) as call:
        yield call.totals.counters


@pytest.fixture(scope="module")
def locus():
    """The locus's reads, and its model built in memory, whole."""
    ref = _ref()
    reads, _, _ = simulate_diploid_reads(
        ref.left_flanking_region, CSTB_PATTERN, 2, 5,
        ref.right_flanking_region, read_length=READ_LEN, coverage=10,
        error_rate=0.002, seed=5)
    vf = _finder()
    return vf, vf.get_model(READ_LEN), reads[0::2], reads[1::2]


def _assert_no_dense(art):
    assert all(getattr(art, f) is None for f in bank.DENSE_FIELDS)


def test_bank_file_is_the_decode_payload(tmp_path, locus):
    _, full, _, _ = locus
    vf = _finder(tmp_path)
    with _call() as counters:
        lm = vf.get_model(READ_LEN)
    path = _bank_path(vf, tmp_path)
    assert os.listdir(tmp_path) == [os.path.basename(path)]
    art, sm = bank.load_reference_payload(path)
    _assert_no_dense(art)
    # the model built in the call keeps its whole artifact
    assert bank.has_dense_tables(lm.art)
    for f in dataclasses.fields(art):
        if f.name not in bank.DENSE_FIELDS:
            np.testing.assert_array_equal(getattr(art, f.name),
                                          getattr(full.art, f.name))
    assert counters["model.built"] == 1
    assert counters["model.bank_bytes_written"] == os.path.getsize(path) > 0
    assert not any(counters.get(c) for c in DENSE_COUNTERS)


def test_decode_from_the_bank_equals_the_full_model(tmp_path, locus):
    full_vf, full, mapped, unmapped = locus
    _finder(tmp_path).get_model(READ_LEN)
    vf = _finder(tmp_path)
    with _call() as counters:
        lm = vf.get_model(READ_LEN)
        got, got_stats = vf.score_reads(mapped, unmapped, READ_LEN)
    want, want_stats = full_vf.score_reads(mapped, unmapped, READ_LEN,
                                           model=full)
    assert len(got) == len(want) > 0
    assert [dataclasses.asdict(r) for r in got] == \
        [dataclasses.asdict(r) for r in want]
    assert got_stats.keys() == want_stats.keys()
    for k in want_stats:
        np.testing.assert_array_equal(got_stats[k], want_stats[k], k)
    path = _bank_path(vf, tmp_path)
    assert counters["model.bank_hit"] == 1
    assert counters["model.bank_bytes_read"] == os.path.getsize(path) > 0
    assert "model.built" not in counters
    assert not any(counters.get(c) for c in DENSE_COUNTERS)
    # the default decode read no dense table
    _assert_no_dense(lm.art)
    assert os.listdir(tmp_path) == [os.path.basename(path)]


def _struct_equal(a: StructDeviceModel, b: StructDeviceModel):
    for f in dataclasses.fields(StructDeviceModel):
        assert torch.equal(getattr(a, f.name), getattr(b, f.name)), f.name


def _paths(full_vf, full, mapped, unmapped):
    """Each scored read's decoded artifact-space path, cut to its length."""
    scored, stats = full_vf.score_reads(mapped, unmapped, READ_LEN,
                                        model=full, return_paths=True)
    return [stats["path"][r.row][:len(r.sequence)] for r in scored]


@pytest.mark.parametrize("companion", [True, False])
def test_dense_tables_load_on_demand(tmp_path, locus, companion):
    """A model read from a decode-only bank builds the ``struct`` decoder's
    tables and expands decoded paths as the whole build does: from the
    companion where the bank has one, else from a rebuild of the locus,
    whose tables are then banked beside it."""
    full_vf, full, mapped, unmapped = locus
    _finder(tmp_path).get_model(READ_LEN)
    dense = bank.dense_payload_path(_bank_path(full_vf, tmp_path))
    # a default-mode build banks no companion
    assert not os.path.exists(dense)
    if companion:
        bank.write_payload(dense, bank.dense_tables(full.art))
    paths = _paths(full_vf, full, mapped, unmapped)
    assert paths
    vf = _finder(tmp_path)
    with _call() as counters:
        lm = vf.get_model(READ_LEN)
        _assert_no_dense(lm.art)
        _struct_equal(lm.struct_model(), full.struct_model())
        for path in paths:
            assert lm.visited_states(path) == full.visited_states(path)
    assert counters.get("model.dense_read", 0) == int(companion)
    assert counters.get("model.dense_rebuild", 0) == int(not companion)
    assert counters.get("model.dense_write", 0) == int(not companion)
    assert "model.built" not in counters
    tables = bank.load_reference_payload(dense)
    for f in bank.DENSE_FIELDS:
        np.testing.assert_array_equal(tables[f], getattr(full.art, f), f)
        np.testing.assert_array_equal(getattr(lm.art, f),
                                      getattr(full.art, f), f)


def test_built_model_banks_its_dense_tables_when_read(tmp_path, locus):
    """A model built in the call keeps its dense tables in memory: a mode
    that reads them rebuilds nothing and writes the bank's companion."""
    full_vf, full, mapped, unmapped = locus
    vf = _finder(tmp_path)
    dense = bank.dense_payload_path(_bank_path(vf, tmp_path))
    with _call() as counters:
        lm = vf.get_model(READ_LEN)
        path = _paths(full_vf, full, mapped, unmapped)[0]
        assert lm.visited_states(path) == full.visited_states(path)
    assert counters["model.built"] == 1
    assert counters["model.dense_write"] == 1
    assert not counters.get("model.dense_read")
    assert not counters.get("model.dense_rebuild")
    assert os.path.exists(dense)


def test_full_bank_payload_keeps_its_tables(tmp_path, locus):
    """A bank file that holds the whole artifact (an earlier bank of the
    port, or the reference's) needs no companion and no rebuild."""
    full_vf, full, _, _ = locus
    path = _bank_path(full_vf, tmp_path)
    bank.write_payload(path, bank.build_locus_payload(
        full_vf.reference_vntr, full_vf.get_copies_for_hmm(READ_LEN),
        READ_LEN, full_vf.config.max_error_rate))
    vf = _finder(tmp_path)
    with _call() as counters:
        lm = vf.get_model(READ_LEN)
        assert lm.source is None and bank.has_dense_tables(lm.art)
        _struct_equal(lm.struct_model(), full.struct_model())
    assert counters["model.bank_hit"] == 1
    assert not any(counters.get(c) for c in DENSE_COUNTERS)
    assert os.listdir(tmp_path) == [os.path.basename(path)]


def test_buildbank_writes_decode_payload_and_companion(tmp_path, capsys):
    db = str(tmp_path / "m.db")
    create_vntrs_database(db)
    for vid, pattern in [(1, "CGCGGGGCGGGG"), (2, "ACGTTAC")]:
        save_reference_vntr_to_database(_ref(vid, pattern), db)
    argv = ["buildbank", "-m", db, "--working_directory", str(tmp_path),
            "-l", str(READ_LEN), "-t", "1"]
    cli.main(argv)
    assert "2 loci to compile (0 already banked)" in capsys.readouterr().out
    bank_dir = tmp_path / "model_bank"
    names = set()
    for ref in load_unique_vntrs_data(db):
        copies = bank.copies_for_hmm(ref.pattern, READ_LEN)
        path = bank.bank_payload_path(str(bank_dir), ref.id, copies,
                                      READ_LEN, 0.05)
        dense = bank.dense_payload_path(path)
        names |= {os.path.basename(path), os.path.basename(dense)}
        art, _ = bank.load_reference_payload(path)
        _assert_no_dense(art)
        tables = bank.load_reference_payload(dense)
        assert set(tables) == set(bank.DENSE_FIELDS)
        full, _ = bank.build_locus_payload(ref, copies, READ_LEN, 0.05)
        for f in bank.DENSE_FIELDS:
            np.testing.assert_array_equal(tables[f], getattr(full, f), f)
    assert set(os.listdir(bank_dir)) == names and len(names) == 4
    cli.main(argv)
    assert "0 loci to compile (2 already banked)" in capsys.readouterr().out
    assert set(os.listdir(bank_dir)) == names
