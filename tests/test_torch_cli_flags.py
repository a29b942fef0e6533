"""The ``genotype`` flags of the Illumina and long-read paths that the
port took over from the reference, held to ``advntr_tpu``'s text on the
same inputs: ``-e/-c`` (the coverage estimate, with a GC corrector attached
by hand and one built from a reference FASTA; test_expansion.py:89, :109,
:134), a CRAM with ``-r`` (test_cram.py:170), ``--haploid``, ``-n`` and
``--accuracy_filter`` with ``-p``."""

import io
import os
import random

import pytest
import torch

from advntr_tpu import cli as jax_cli
from advntr_tpu.config import Config as JConfig
from advntr_tpu.engine.analyzer import GenomeAnalyzer as JAnalyzer
from advntr_tpu_torch import cli
from advntr_tpu_torch.config import Config
from advntr_tpu_torch.engine.analyzer import GenomeAnalyzer
from advntr_tpu_torch.engine.coverage_bias import GC_CONTENT_WINDOW_SIZE
from advntr_tpu_torch.engine.simulate import simulate_diploid_reads
from advntr_tpu_torch.io.bam import BamRead, BamWriter, build_bai
from advntr_tpu_torch.io.cram import CramWriter
from advntr_tpu_torch.models.db import (create_vntrs_database,
                                        save_reference_vntr_to_database)
from advntr_tpu_torch.models.reference_vntr import ReferenceVNTR
from advntr_tpu_torch.synthetic import (CSTB_PATTERN, write_cstb_sample,
                                        write_pacbio_panel)

# the suite runs test files in parallel worker processes: one torch thread
# each keeps them from oversubscribing the cores
torch.set_num_threads(1)


def _rand_seq(seed, n):
    rng = random.Random(seed)
    return "".join(rng.choice("ACGT") for _ in range(n))


def _both(tmp_path, argv, name):
    """``argv`` through both CLIs, each with its own working directory and
    output file; (port's text, reference's text)."""
    texts = []
    for label, main, extra in (("own", cli.main, ["--device", "cpu"]),
                               ("ref", jax_cli.main, [])):
        wd = tmp_path / f"{name}_{label}"
        os.makedirs(wd)
        out = str(wd / "out.txt")
        main(argv + ["--working_directory", str(wd), "--disable_logging",
                     "-o", out] + extra)
        with open(out) as fh:
            texts.append(fh.read())
    return texts


# ---- -e/-c: the coverage estimate --------------------------------------

EXP_PATTERN = "GATCGATTCGAA"


def _expansion_ref():
    ref = ReferenceVNTR(77, EXP_PATTERN, 1000, "chr1")
    ref.repeat_segments = [EXP_PATTERN] * 3
    ref.left_flanking_region = _rand_seq(41, 200)
    ref.right_flanking_region = _rand_seq(42, 200)
    return ref


@pytest.fixture(scope="module")
def expansion(tmp_path_factory):
    """test_expansion.py's sample: 8/8 copies at coverage 30, every read
    unmapped, and its one-locus DB."""
    tmp = tmp_path_factory.mktemp("torch_expansion")
    ref = _expansion_ref()
    reads, _, _ = simulate_diploid_reads(
        ref.left_flanking_region, EXP_PATTERN, 8, 8,
        ref.right_flanking_region, read_length=100, coverage=30,
        error_rate=0.0, seed=5)
    bam = str(tmp / "exp.bam")
    with BamWriter(bam, ["chr1"], [100000]) as w:
        for name, seq in reads:
            w.write(BamRead(name, 4, -1, -1, 0, [], seq, [38] * len(seq)))
    db = str(tmp / "exp.db")
    create_vntrs_database(db)
    save_reference_vntr_to_database(ref, db)
    return {"bam": bam, "db": db}


@pytest.mark.parametrize("coverage", ["30", "60"])
def test_expansion_coverage_estimate_equals_reference(expansion, tmp_path,
                                                      coverage):
    """test_expansion.py:89 through both CLIs (``-e -c``): the same
    homozygous estimate, halved at twice the coverage."""
    own, ref = _both(tmp_path, ["genotype", "-a", expansion["bam"], "-m",
                                expansion["db"], "-e", "-c", coverage],
                     "exp")
    assert own == ref
    vid, call = own.split()
    a, b = call.split("/")
    assert vid == "77" and a == b
    assert (4 <= int(a) <= 9) if coverage == "30" else (2 <= int(a) <= 4)


def test_expansion_needs_coverage(expansion):
    with pytest.raises(SystemExit) as exc:
        cli.main(["genotype", "-a", expansion["bam"], "-m", expansion["db"],
                  "-e", "--device", "cpu"])
    assert "average coverage" in str(exc.value.code)


class Doubler:
    def get_scaled_coverage(self, ref_vntr, observed):
        return observed * 2.0


def test_expansion_gc_correction_equals_reference(expansion, tmp_path):
    """test_expansion.py:109: a corrector attached to each finder rescales
    the occurrence mass before the division, in both packages alike."""
    texts = []
    for cls, config, kw in ((GenomeAnalyzer, Config(), {"device": "cpu"}),
                            (JAnalyzer, JConfig(), {})):
        out = io.StringIO()
        analyzer = cls([_expansion_ref()], [77],
                       str(tmp_path / cls.__module__) + "/", "text",
                       config=config, out=out, input_file=expansion["bam"],
                       **kw)
        for finder in analyzer.vntr_finder.values():
            finder.coverage_corrector = Doubler()
        analyzer.find_repeat_counts_from_alignment_file(
            expansion["bam"], average_coverage=30)
        texts.append(out.getvalue())
    assert texts[0] == texts[1]
    assert int(texts[0].split()[1].split("/")[0]) >= 8


def test_expansion_corrector_from_fasta_equals_reference(tmp_path):
    """test_expansion.py:134 through both CLIs: ``-e -c -r`` builds the GC
    corrector from the reference FASTA and the mapped reads, and scales
    the estimate of a locus expanded to 10 copies of GATC (3 in the DB);
    the same text and the same corrector."""
    # windows of GC 0, 1 and 0.4 before the locus; its units (GC 0.5)
    # fall in the corrector's bin 4, the 0.4 windows' bin
    win = GC_CONTENT_WINDOW_SIZE
    left, right = _rand_seq(1, 120), _rand_seq(2, 120)
    background = ("A" * win + "G" * win + ("GATCA" * win)[:win]) * 3
    chrom = background + left + "GATC" * 10 + right + background
    fasta = tmp_path / "ref.fa"
    fasta.write_text(">chr1\n" + chrom + "\n")
    bam = str(tmp_path / "m.bam")
    with BamWriter(bam, ["chr1"], [len(chrom)]) as w:
        for start in range(0, len(chrom) - 100, 10):
            seq = chrom[start:start + 100]
            w.write(BamRead("r%d" % start, 0, 0, start, 60, [(0, 100)], seq,
                            [38] * 100, "chr1"))
    build_bai(bam)
    ref = ReferenceVNTR(5, "GATC", len(background) + len(left), "chr1")
    ref.repeat_segments = ["GATC"] * 3
    ref.left_flanking_region, ref.right_flanking_region = left, right
    db = str(tmp_path / "m.db")
    create_vntrs_database(db)
    save_reference_vntr_to_database(ref, db)
    own, want = _both(tmp_path, ["genotype", "-a", bam, "-m", db, "-e", "-c",
                                 "10", "-r", str(fasta)], "gc")
    assert own == want and own.split()[0] == "5"
    assert own.split()[1] != "0/0"
    means = []
    for cls, config, kw in ((GenomeAnalyzer, Config(), {"device": "cpu"}),
                            (JAnalyzer, JConfig(), {})):
        analyzer = cls([ref], [5], str(tmp_path) + "/", "text",
                       config=config, out=io.StringIO(),
                       ref_filename=str(fasta), input_file=bam, **kw)
        analyzer._attach_coverage_corrector(bam)
        corrector = analyzer.vntr_finder[5].coverage_corrector
        means.append((corrector.get_sequencing_mean_coverage(),
                      corrector.get_scaled_coverage(ref, 10.0)))
    assert means[0] == means[1] and means[0][0] > 0


# ---- a CRAM with -r ----------------------------------------------------

def test_genotype_cli_on_cram_equals_reference(tmp_path):
    """test_cram.py:170 through both CLIs: the CSTB 2/5 sample as a CRAM
    against its reference FASTA."""
    left, right, start = _rand_seq(1, 300), _rand_seq(2, 300), 5000
    db = str(tmp_path / "models.db")
    ref = ReferenceVNTR(301645, CSTB_PATTERN, start, "chr21", "CSTB",
                        "Promoter", 3)
    ref.repeat_segments = [CSTB_PATTERN] * 3
    ref.left_flanking_region, ref.right_flanking_region = left, right
    create_vntrs_database(db)
    save_reference_vntr_to_database(ref, db)
    chrom = (_rand_seq(8, start - 300) + left + CSTB_PATTERN * 3 + right
             + _rand_seq(9, 3000))
    fasta = str(tmp_path / "ref.fa")
    with open(fasta, "w") as fh:
        fh.write(">chr21\n" + chrom + "\n")
    reads, _, _ = simulate_diploid_reads(
        left, CSTB_PATTERN, 2, 5, right, read_length=100, coverage=40,
        error_rate=0.002, seed=5)
    mapped, unmapped = [], []
    for i, (name, seq) in enumerate(reads):
        if i % 2 == 0:
            mapped.append(BamRead(name, 0, 0, start - 50 + (i % 100), 60,
                                  [(0, len(seq))], seq, [38] * len(seq),
                                  "chr21"))
        else:
            unmapped.append(BamRead(name, 4, -1, -1, 0, [], seq,
                                    [38] * len(seq), None))
    mapped.sort(key=lambda r: r.reference_start)
    cram = str(tmp_path / "sample.cram")
    with CramWriter(cram, ["chr21"], [len(chrom)],
                    reference_seqs={"chr21": chrom},
                    records_per_container=500) as w:
        for r in mapped + unmapped:
            w.write(r)
    own, want = _both(tmp_path, ["genotype", "-a", cram, "-m", db, "-r",
                                 fasta], "cram")
    assert own == want
    assert own.splitlines() == ["301645", "2/5"]


# ---- --haploid and -n on the CSTB fixture ----------------------------------

@pytest.fixture(scope="module")
def cstb(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_flags_cstb")
    return write_cstb_sample(str(tmp), coverage=20)


@pytest.mark.parametrize("flag", ["--haploid", "-n"])
def test_illumina_flag_equals_reference(cstb, tmp_path, flag):
    db, bam = cstb
    own, want = _both(tmp_path, ["genotype", "-a", bam, "-m", db, flag],
                      flag.strip("-"))
    assert own == want
    assert own.split()[0] == "301645"
    if flag == "--haploid":
        assert "/" not in own.split()[1]


# ---- long reads: --accuracy_filter and -n with -p ---------------------------

@pytest.fixture(scope="module")
def pacbio(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_flags_pacbio")
    db, fa, truth, _ = write_pacbio_panel(str(tmp), n_loci=2, coverage=6,
                                          long_locus=None)
    return db, fa, truth


@pytest.mark.parametrize("flag", ["--accuracy_filter", "-n"])
def test_long_read_flag_equals_reference(pacbio, tmp_path, flag):
    db, fa, truth = pacbio
    own, want = _both(tmp_path, ["genotype", "-p", "-f", fa, "-m", db, flag],
                      flag.strip("-"))
    assert own == want
    assert own.split()[0::2] == [str(v) for v in truth]
