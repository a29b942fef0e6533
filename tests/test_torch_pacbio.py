"""The port's long-read (PacBio) path on the CPU against the JAX package
on the same seeded inputs: the inputs of tests/test_pacbio_end_to_end.py,
tests/test_pacbio_mapped.py and tests/test_pacbio_long_lattice.py, and the
CLI with ``-p -f`` and ``-p -a``.  Everything compared is integer or text
(spanning windows, read counts, genotypes, output lines), so equality is
exact; the long-lattice case is held to its simulated genotype, which is
what the reference's own test holds the reference to."""

import io
import random

import pytest
import torch

from advntr_tpu.config import Config as JConfig
from advntr_tpu.engine.analyzer import GenomeAnalyzer as JAnalyzer
from advntr_tpu.engine.finder import VNTRFinder as JFinder
from advntr_tpu.models.db import load_unique_vntrs_data as jload
from advntr_tpu.models.reference_vntr import ReferenceVNTR as JRef
from advntr_tpu_torch import cli, dna
from advntr_tpu_torch.config import Config
from advntr_tpu_torch.engine import device_analytics as tda
from advntr_tpu_torch.engine.analyzer import GenomeAnalyzer
from advntr_tpu_torch.engine.finder import VNTRFinder
from advntr_tpu_torch.models import bank
from advntr_tpu_torch.engine.simulate import haplotype_sequence, mutate
from advntr_tpu_torch.io.bam import BamRead, BamReader, BamWriter, build_bai
from advntr_tpu_torch.models.db import (create_vntrs_database,
                                        load_unique_vntrs_data,
                                        save_reference_vntr_to_database)
from advntr_tpu_torch.models.reference_vntr import ReferenceVNTR
from advntr_tpu_torch.synthetic import rand_seq, write_pacbio_panel

# the suite runs test files in parallel worker processes: one torch thread
# each keeps them from oversubscribing the cores
torch.set_num_threads(1)

PATTERN = "CATCAGTTGA"
LEFT, RIGHT = rand_seq(3, 300), rand_seq(4, 300)


def _fill(ref, pattern, copies, left, right):
    ref.repeat_segments = [pattern] * copies
    ref.left_flanking_region = left
    ref.right_flanking_region = right
    ref.estimated_repeats = copies
    return ref


def _finders(pattern=PATTERN, copies=5, left=LEFT, right=RIGHT, start=5000):
    """(port finder on the CPU, reference finder) of one locus."""
    own = _fill(ReferenceVNTR(70186, pattern, start, "chr1"), pattern,
                copies, left, right)
    ref = _fill(JRef(70186, pattern, start, "chr1"), pattern, copies, left,
                right)
    return (VNTRFinder(own, Config().with_platform(pacbio=True),
                       device="cpu"),
            JFinder(ref, JConfig().with_platform(pacbio=True)))


def simulate_long_reads(alleles, n_per_hap=6, error=0.01, seed=0):
    rng = random.Random(seed)
    reads = []
    for h, copies in enumerate(alleles):
        hap = haplotype_sequence(LEFT, PATTERN, copies, RIGHT)
        for k in range(n_per_hap):
            # long read spanning the whole VNTR with generous flanks
            start = rng.randint(0, 80)
            end = len(hap) - rng.randint(0, 80)
            reads.append((f"h{h}r{k}", mutate(hap[start:end], error, rng)))
    rng.shuffle(reads)
    return reads


def _same_result(got, want):
    assert got.copy_numbers is not None
    assert tuple(got.copy_numbers) == tuple(want.copy_numbers)
    assert got.spanning_reads_count == want.spanning_reads_count
    assert got.recruited_reads_count == want.recruited_reads_count
    assert got.maximum_likelihood == pytest.approx(want.maximum_likelihood)


def test_pacbio_spanning_extraction():
    own, ref = _finders()
    reads = simulate_long_reads((4, 7))
    spanning, length_dist = \
        own.get_spanning_reads_of_unaligned_pacbio_reads(reads)
    assert (spanning, length_dist) == \
        ref.get_spanning_reads_of_unaligned_pacbio_reads(reads)
    assert len(spanning) == len(reads)
    lengths = sorted(len(s) for _, s in spanning)
    assert abs(lengths[0] - (200 + 4 * len(PATTERN))) <= 12
    assert abs(lengths[-1] - (200 + 7 * len(PATTERN))) <= 12


def test_pacbio_genotype():
    own, ref = _finders()
    reads = simulate_long_reads((4, 7))
    result = own.find_repeat_count_pacbio(reads)
    _same_result(result, ref.find_repeat_count_pacbio(None, reads))
    assert tuple(sorted(result.copy_numbers)) == (4, 7)


def test_pacbio_naive_homozygous():
    own, ref = _finders()
    reads = simulate_long_reads((6, 6), error=0.0)
    result = own.find_repeat_count_pacbio(reads, naive=True)
    _same_result(result, ref.find_repeat_count_pacbio(None, reads,
                                                      naive=True))
    assert result.copy_numbers == (6, 6)


def test_pacbio_reverse_complement_reads():
    own, ref = _finders()
    reads = [(n, dna.revcomp(s)) for n, s in simulate_long_reads((5, 5))]
    result = own.find_repeat_count_pacbio(reads)
    _same_result(result, ref.find_repeat_count_pacbio(None, reads))
    assert tuple(sorted(result.copy_numbers)) == (5, 5)


def test_pacbio_haplotype_copy_numbers():
    own, ref = _finders()
    reads = simulate_long_reads((4, 7), error=0.005, seed=2)
    spanning, _ = own.get_spanning_reads_of_unaligned_pacbio_reads(reads)
    got = own.get_haplotype_copy_numbers_from_spanning_reads(spanning)
    assert got == ref.get_haplotype_copy_numbers_from_spanning_reads(spanning)
    assert sorted(got) == [4, 7]


# ---- aligned long reads (tests/test_pacbio_mapped.py) ----------------------

M_PATTERN = "GATCCGTTAC"
M_LEFT, M_RIGHT = rand_seq(31, 400), rand_seq(32, 400)
VNTR_START, REF_COPIES = 2000, 5


def make_mapped_long_reads(alleles=(4, 7), n_per_hap=5, error=0.005, seed=3):
    """Long reads mapped over the locus, with one I/D operation at the
    repeat midpoint where the allele differs from the reference."""
    rng = random.Random(seed)
    reads = []
    ref_len = REF_COPIES * len(M_PATTERN)
    for h, copies in enumerate(alleles):
        hap = haplotype_sequence(M_LEFT, M_PATTERN, copies, M_RIGHT)
        allele_len = copies * len(M_PATTERN)
        for k in range(n_per_hap):
            lead = rng.randint(150, 250)   # flank bases before the VNTR
            tail = rng.randint(150, 250)
            seq = mutate(hap[len(M_LEFT) - lead:
                             len(M_LEFT) + allele_len + tail], error, rng)
            if allele_len == ref_len:
                cigar = [(0, len(seq))]
            elif allele_len > ref_len:
                mid = lead + ref_len // 2
                cigar = [(0, mid), (1, allele_len - ref_len),
                         (0, len(seq) - mid - (allele_len - ref_len))]
            else:
                mid = lead + allele_len // 2
                cigar = [(0, mid), (2, ref_len - allele_len),
                         (0, len(seq) - mid)]
            reads.append(BamRead(f"h{h}r{k}", 0, 0, VNTR_START - lead, 60,
                                 cigar, seq, [30] * len(seq)))
    reads.sort(key=lambda r: r.reference_start)
    return reads


def _write_mapped(tmp_path):
    bam_path = str(tmp_path / "pb.bam")
    reads = make_mapped_long_reads()
    with BamWriter(bam_path, ["chr1"], [100000]) as w:
        for r in reads:
            w.write(r)
    build_bai(bam_path)
    return bam_path, reads


def test_mapped_spanning_walk(tmp_path):
    from advntr_tpu.io.bam import BamReader as JBamReader
    bam_path, reads = _write_mapped(tmp_path)
    own, ref = _finders(M_PATTERN, REF_COPIES, M_LEFT, M_RIGHT, VNTR_START)
    with BamReader(bam_path) as bam:
        spanning = own.get_spanning_reads_of_aligned_pacbio_reads(bam)
    with JBamReader(bam_path) as bam:
        assert spanning == ref.get_spanning_reads_of_aligned_pacbio_reads(bam)
    assert len(spanning) == len(reads)
    for name, seq in spanning:
        assert len(seq) >= 100 + 4 * len(M_PATTERN)


def _mapped_db(tmp_path):
    db_file = str(tmp_path / "pb.db")
    create_vntrs_database(db_file)
    own, _ = _finders(M_PATTERN, REF_COPIES, M_LEFT, M_RIGHT, VNTR_START)
    save_reference_vntr_to_database(own.reference_vntr, db_file)
    return db_file


def test_pacbio_bam_genotype_end_to_end(tmp_path):
    db_file = _mapped_db(tmp_path)
    bam_path, _ = _write_mapped(tmp_path)
    texts = []
    # each package banks its models in a working directory of its own: the
    # port's bank files hold decode payloads, which the reference's struct
    # kernel cannot decode
    for analyzer_cls, load, config, kw, wd in (
            (GenomeAnalyzer, load_unique_vntrs_data, Config(),
             {"device": "cpu"}, tmp_path / "own"),
            (JAnalyzer, jload, JConfig(), {}, tmp_path / "ref")):
        out = io.StringIO()
        wd.mkdir()
        analyzer = analyzer_cls(
            load(db_file), [70186], str(wd) + "/", "text",
            config=config.with_platform(pacbio=True), out=out,
            input_file=bam_path, **kw)
        analyzer.find_repeat_counts_from_pacbio_alignment_file(bam_path)
        texts.append(out.getvalue())
    assert texts[0] == texts[1]
    assert texts[0].strip().splitlines() == ["70186", "4/7"]


def test_cli_pacbio_alignment_file(tmp_path):
    db_file = _mapped_db(tmp_path)
    bam_path, _ = _write_mapped(tmp_path)
    out = str(tmp_path / "out.txt")
    cli.main(["genotype", "-p", "-a", bam_path, "-m", db_file,
              "--working_directory", str(tmp_path), "--disable_logging",
              "-o", out, "--device", "cpu"])
    assert open(out).read().split() == ["70186", "4/7"]


# ---- reads from a FASTA file through the CLI -------------------------------

@pytest.fixture(scope="module")
def pacbio_fasta(tmp_path_factory):
    """A three-locus panel of noisy 3 kb reads in both orientations, and
    the reference analyzer's text on it (its CPU default, the struct
    kernel, decodes every window)."""
    tmp = tmp_path_factory.mktemp("pacbio_fasta")
    db, fa, truth, _ = write_pacbio_panel(str(tmp), n_loci=3, coverage=6,
                                          long_locus=None)
    ref_out = io.StringIO()
    refs = jload(db)
    JAnalyzer(refs, [r.id for r in refs], str(tmp) + "/", "text",
              config=JConfig().with_platform(pacbio=True),
              out=ref_out).find_repeat_counts_from_pacbio_reads(fa)
    return dict(db=db, fa=fa, truth=truth, ref=ref_out.getvalue())


def _pacbio_argv(panel, workdir, out):
    return ["genotype", "-p", "-f", panel["fa"], "-m", panel["db"],
            "--working_directory", str(workdir), "--disable_logging", "-o",
            out, "--device", "cpu"]


def test_cli_pacbio_fasta_equals_reference(tmp_path, pacbio_fasta):
    """``genotype -p -f`` on the panel: the port's text equals the
    reference analyzer's on the same files, every locus at its simulated
    genotype; ``--naive`` runs the haplotyper path to the same kind of
    output."""
    truth = pacbio_fasta["truth"]
    out = str(tmp_path / "out.txt")
    argv = _pacbio_argv(pacbio_fasta, tmp_path, out)
    cli.main(argv)
    text = open(out).read()
    assert text == pacbio_fasta["ref"]
    lines = text.split()
    assert dict(zip(lines[0::2], lines[1::2])) == \
        {str(vid): "%d/%d" % ab for vid, ab in truth.items()}
    cli.main(argv + ["--naive"])
    naive = open(out).read().split()
    assert naive[0::2] == lines[0::2]
    assert all(call == "None" or "/" in call for call in naive[1::2])


def test_cli_pacbio_struct_kernel_equals_reference(tmp_path, pacbio_fasta,
                                                   monkeypatch):
    """``ADVNTR_TPU_KERNEL=struct``: every window decodes through the
    port's structured decoder, and the text is the reference analyzer's."""
    monkeypatch.setenv("ADVNTR_TPU_KERNEL", "struct")
    calls = []
    for name in ("read_stats_struct", "read_stats_struct_ckpt"):
        orig = getattr(tda, name)

        def spy(*a, _orig=orig, _name=name, **k):
            calls.append(_name)
            return _orig(*a, **k)
        monkeypatch.setattr(tda, name, spy)
    monkeypatch.setattr(tda, "read_stats",
                        lambda *a, **k: calls.append("pallas"))
    out = str(tmp_path / "out.txt")
    cli.main(_pacbio_argv(pacbio_fasta, tmp_path, out))
    assert open(out).read() == pacbio_fasta["ref"]
    assert calls and "pallas" not in calls


@pytest.mark.parametrize("step", ["model build", "haplotyper"])
def test_cli_pacbio_host_error_gives_the_error_row(tmp_path, monkeypatch,
                                                   step):
    """A host step that fails in one locus (its model build; the
    haplotyper of ``--naive``) prints that locus's Error row and the run
    goes on to the next locus, with the reference analyzer's text on the
    same inputs and the same failure."""
    from advntr_tpu.engine.haplotyper import PacBioHaplotyper as JHap
    from advntr_tpu_torch.engine.haplotyper import PacBioHaplotyper
    db, fa, truth, _ = write_pacbio_panel(str(tmp_path), n_loci=3,
                                          coverage=6, long_locus=None)
    bad = sorted(truth)[0]
    naive = step == "haplotyper"
    if naive:
        for cls in (PacBioHaplotyper, JHap):
            orig = cls.get_error_corrected_haplotypes
            calls = []

            def corrected(self, *a, orig=orig, calls=calls, **kw):
                calls.append(1)
                if len(calls) == 1:
                    raise RuntimeError("haplotyper failed")
                return orig(self, *a, **kw)
            monkeypatch.setattr(cls, "get_error_corrected_haplotypes",
                                corrected)
    else:
        # the port's host build (the upload to the device is not host work)
        def payload(bank_dir, ref_vntr, *a, orig=bank.read_or_build):
            if ref_vntr.id == bad:
                raise RuntimeError("model build failed")
            return orig(bank_dir, ref_vntr, *a)
        monkeypatch.setattr(bank, "read_or_build", payload)

        def get_model(self, *a, orig=JFinder.get_model, **kw):
            if self.reference_vntr.id == bad:
                raise RuntimeError("model build failed")
            return orig(self, *a, **kw)
        monkeypatch.setattr(JFinder, "get_model", get_model)
    out = str(tmp_path / "out.txt")
    cli.main(["genotype", "-p", "-f", fa, "-m", db, "--working_directory",
              str(tmp_path), "--disable_logging", "-o", out, "--device",
              "cpu"] + (["--naive"] if naive else []))
    text = open(out).read()
    ref_out = io.StringIO()
    refs = jload(db)
    # the reference banks its models apart from the port's decode payloads
    ref_wd = tmp_path / "ref"
    ref_wd.mkdir()
    JAnalyzer(refs, [r.id for r in refs], str(ref_wd) + "/", "text",
              config=JConfig().with_platform(pacbio=True),
              out=ref_out).find_repeat_counts_from_pacbio_reads(
                  fa, naive=naive)
    assert text == ref_out.getvalue()
    lines = text.split()
    calls = dict(zip(lines[0::2], lines[1::2]))
    assert calls[str(bad)] == "Error"
    assert len(calls) == len(truth)
    if not naive:
        assert all(calls[str(v)] == "%d/%d" % ab
                   for v, ab in truth.items() if v != bad)


@pytest.mark.parametrize("error", [
    torch.cuda.OutOfMemoryError("CUDA out of memory"),
    RuntimeError("CUDA error: an illegal memory access was encountered")])
def test_cli_pacbio_device_error_propagates(tmp_path, monkeypatch, error):
    """An error of the model's upload to the device is not a host step's:
    ``genotype -p`` raises it instead of printing an Error row."""
    from advntr_tpu_torch.ops.struct_model import TorchStructModel
    db, fa, truth, _ = write_pacbio_panel(str(tmp_path), n_loci=2,
                                          coverage=4, long_locus=None)

    def upload(*a, **kw):
        raise error
    monkeypatch.setattr(TorchStructModel, "from_payload", upload)
    out = str(tmp_path / "out.txt")
    with pytest.raises(type(error), match="CUDA"):
        cli.main(["genotype", "-p", "-f", fa, "-m", db,
                  "--working_directory", str(tmp_path), "--disable_logging",
                  "-o", out, "--device", "cpu"])


# ---- a multi-kb lattice (tests/test_pacbio_long_lattice.py) ----------------

def test_pacbio_5kb_window_routes_through_ckpt_kernel(monkeypatch):
    """Alleles 160/165 of a 30-base motif give trimmed windows of 5.0 to
    5.2 kb: they must take the checkpointed traceback (run_device,
    L > CKPT_TRACEBACK_L) on a model of more than 1,024 positions, and
    still genotype correctly."""
    pattern = "CATCAGTTGACGTAGCATCAGTTGACGTAG"
    left, right = rand_seq(13, 300), rand_seq(14, 300)
    ref = _fill(ReferenceVNTR(71001, pattern, 5000, "chr1"), pattern, 100,
                left, right)
    alleles = (160, 165)
    rng = random.Random(77)
    reads = []
    for h, copies in enumerate(alleles):
        hap = haplotype_sequence(left, pattern, copies, right)
        for k in range(2):
            start = rng.randint(0, 100)
            end = len(hap) - rng.randint(0, 100)
            reads.append((f"h{h}r{k}", mutate(hap[start:end], 0.005, rng)))
    finder = VNTRFinder(ref, Config().with_platform(pacbio=True),
                        device="cpu")
    calls = {"ckpt": 0, "max_L": 0, "P": 0}
    orig = tda.read_stats_ckpt

    def spy(model, seqs, lengths, **kw):
        calls["ckpt"] += 1
        calls["max_L"] = max(calls["max_L"], int(seqs.shape[1]))
        calls["P"] = model.P
        return orig(model, seqs, lengths, **kw)

    monkeypatch.setattr(tda, "read_stats_ckpt", spy)
    result = finder.find_repeat_count_pacbio(reads)
    assert calls["ckpt"] >= 1, "5kb window must use the ckpt traceback"
    assert calls["max_L"] >= 5000 and calls["P"] > 1024, calls
    assert result.spanning_reads_count == len(reads)
    assert tuple(sorted(result.copy_numbers)) == alleles, result.copy_numbers
