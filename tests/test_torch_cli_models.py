"""The port's model-database subcommands against ``advntr_tpu.cli``:
``viewmodel`` and ``delmodel`` (test_cli_models.py:28, :40), ``buildbank``
(test_cli_end_to_end.py:109) through a pool of spawned workers, and
``addmodel`` through the CLI: the same printed text and database rows."""

import os
import random
import sqlite3
import warnings

import pytest
import torch

from advntr_tpu import cli as jax_cli
from advntr_tpu.models import db as jdb
from advntr_tpu_torch import cli
from advntr_tpu_torch.io.fasta import write_fasta
from advntr_tpu_torch.models.db import (create_vntrs_database,
                                        load_unique_vntrs_data,
                                        save_reference_vntr_to_database)
from advntr_tpu_torch.models.reference_vntr import ReferenceVNTR
from advntr_tpu_torch.synthetic import write_cstb_sample

# the suite runs test files in parallel worker processes: one torch thread
# each keeps them from oversubscribing the cores
torch.set_num_threads(1)


def _db(path):
    """test_cli_models.py's two-locus DB, written by the port."""
    create_vntrs_database(path)
    for vid, gene, pattern in [(1, "CSTB", "CGCGGGGCGGGG"),
                               (2, "MUC1", "ACGTACGTACGTACGTACGT")]:
        ref = ReferenceVNTR(vid, pattern, 1000 * vid, "chr1", gene, "Coding")
        ref.repeat_segments = [pattern] * 3
        ref.left_flanking_region = "A" * 60
        ref.right_flanking_region = "G" * 60
        save_reference_vntr_to_database(ref, path)
    return path


@pytest.mark.parametrize("flags", [[], ["-g", "CSTB"],
                                   ["-p", "cgcggggcgggg"],
                                   ["-g", "cstb,muc1"], ["-g", "none"]])
def test_viewmodel_equals_reference(tmp_path, capsys, flags):
    path = _db(str(tmp_path / "m.db"))
    jax_cli.main(["viewmodel", "-m", path] + flags)
    want = capsys.readouterr().out
    cli.main(["viewmodel", "-m", path] + flags)
    got = capsys.readouterr().out
    assert got == want
    assert ("MUC1" in got) == (flags in ([], ["-g", "cstb,muc1"]))


def test_viewmodel_refuses_a_bad_pattern(tmp_path):
    path = _db(str(tmp_path / "m.db"))
    with pytest.raises(SystemExit) as exc:
        cli.main(["viewmodel", "-m", path, "-p", "ACGN"])
    assert "Pattern should only contain" in str(exc.value.code)


def test_delmodel(tmp_path):
    """test_cli_models.py:40 on the port, and the reference's delmodel on
    a copy of the same DB leaving the same rows."""
    own, ref = _db(str(tmp_path / "own.db")), _db(str(tmp_path / "ref.db"))
    cli.main(["delmodel", "-vid", "1", "-m", own])
    jax_cli.main(["delmodel", "-vid", "1", "-m", ref])
    assert [v.id for v in load_unique_vntrs_data(own)] == [2]
    assert [v.id for v in jdb.load_unique_vntrs_data(ref)] == [2]
    with pytest.raises(SystemExit) as exc:
        cli.main(["delmodel", "-m", own])
    assert "--vntr_id is required" in str(exc.value.code)


@pytest.fixture(scope="module")
def cstb(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_cli_models")
    db, bam = write_cstb_sample(str(tmp), coverage=20)
    return {"db": db, "bam": bam, "dir": tmp}


def test_buildbank_precompiles_and_reused(cstb, tmp_path, monkeypatch,
                                          capsys):
    """test_cli_end_to_end.py:109 on the port with two spawned workers:
    the reference's file name (beside it the dense tables' companion), a
    rerun that builds nothing, and a warm genotype run with no host model
    build; the reference's buildbank writes the same file name."""
    import advntr_tpu_torch.models.bank as bank

    wd = str(tmp_path / "own")
    argv = ["buildbank", "-m", cstb["db"], "--working_directory", wd,
            "-l", "100", "-t", "2"]
    cli.main(argv)
    assert "1 loci to compile (0 already banked), 2 workers" in \
        capsys.readouterr().out
    bank_dir = os.path.join(wd, "model_bank")
    files = sorted(os.listdir(bank_dir))
    jax_cli.main(["buildbank", "-m", cstb["db"], "--working_directory",
                  str(tmp_path / "ref"), "-l", "100", "-t", "1"])
    ref_files = os.listdir(tmp_path / "ref" / "model_bank")
    assert len(ref_files) == 1 and ref_files[0].startswith("model_301645_")
    assert files == sorted(ref_files +
                           [bank.dense_payload_path(ref_files[0])])
    cli.main(argv)
    assert "0 loci to compile (1 already banked)" in capsys.readouterr().out
    assert sorted(os.listdir(bank_dir)) == files

    def boom(*a, **k):
        raise AssertionError("host model build ran despite a warm bank")

    monkeypatch.setattr(bank, "build_locus_payload", boom)
    out = os.path.join(wd, "warm.txt")
    cli.main(["genotype", "-a", cstb["bam"], "-m", cstb["db"],
              "--working_directory", wd, "--disable_logging", "-o", out,
              "--device", "cpu"])
    with open(out) as fh:
        assert fh.read().splitlines() == ["301645", "2/5"]


def test_buildbank_selects_loci_by_id(tmp_path, capsys):
    path = _db(str(tmp_path / "m.db"))
    cli.main(["buildbank", "-m", path, "--working_directory",
              str(tmp_path), "-l", "60", "-t", "1", "-vid", "2"])
    assert "1 loci to compile" in capsys.readouterr().out
    assert {f.split("_")[1] for f in
            os.listdir(tmp_path / "model_bank")} == {"2"}


def _rand_seq(seed, n):
    rng = random.Random(seed)
    return "".join(rng.choice("ACGT") for _ in range(n))


PATTERN = "GATTCGAGGCTT"


def test_addmodel_cli_equals_reference(tmp_path, capsys):
    """``addmodel`` through both CLIs on test_training_end_to_end.py's
    chromosome, into DBs that already hold two loci: the same printed
    line, the new ID 3, and the same row."""
    chromosome = _rand_seq(11, 8000) + PATTERN * 4 + _rand_seq(12, 8000)
    fa = str(tmp_path / "ref.fa")
    write_fasta(fa, [("chrT", chromosome)])
    argv = ["addmodel", "-r", fa, "-c", "chrT", "-p", PATTERN, "-s", "8000",
            "-e", str(8000 + 4 * len(PATTERN)), "-g", "TESTG", "-a",
            "Coding"]
    own, ref = _db(str(tmp_path / "own.db")), _db(str(tmp_path / "ref.db"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jax_cli.main(argv + ["-m", ref])
    want = capsys.readouterr().out
    cli.main(argv + ["-m", own, "--device", "cpu"])
    got = capsys.readouterr().out
    assert got == want == \
        "Training completed. VNTR saved with ID: 3 to the database\n"

    def rows(path):
        with sqlite3.connect(path) as conn:
            return conn.execute("SELECT * FROM vntrs ORDER BY id").fetchall()

    assert rows(own) == rows(ref) and len(rows(own)) == 3
    new = load_unique_vntrs_data(own)[-1]
    assert new.get_repeat_segments() == [PATTERN] * 4
    assert new.scaled_score != 0


def test_addmodel_flags(tmp_path):
    """A missing required flag stops addmodel before any work, and
    ``--device cuda`` without a GPU refuses and names ``--device cpu``."""
    with pytest.raises(SystemExit) as exc:
        cli.main(["addmodel", "-r", "x.fa", "-c", "chr1", "-p", "ACGT",
                  "-s", "10", "--device", "cpu"])
    assert "--end is required" in str(exc.value.code)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["addmodel", "-r", "x.fa", "-c", "chr1", "-p", "ACGT",
                  "-s", "10", "-e", "30", "-m", str(tmp_path / "m.db")])
