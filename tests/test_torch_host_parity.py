"""The port's copies of the reference's host modules against the
originals: seeded inputs through each copy and its original give equal
results, and each copy's text equals the original's once the package name
in its import lines is normalised, except for the differences listed in
``INTENDED``.  Exact everywhere: the copies run the same numpy and Python
code on the same inputs."""

import dataclasses
import difflib
import random
import re
from pathlib import Path

import numpy as np
import pytest

import advntr_tpu
import advntr_tpu_torch
from advntr_tpu import dna as jdna
from advntr_tpu.engine import coverage_bias as jcov
from advntr_tpu.engine import genotype as jgeno
from advntr_tpu.engine import simulate as jsim
from advntr_tpu.io import bam as jbam
from advntr_tpu.io import cram as jcram
from advntr_tpu.io import fasta as jfasta
from advntr_tpu.io import sam as jsam
from advntr_tpu.models import compiler as jcomp
from advntr_tpu.models import graph as jgraph
from advntr_tpu.models import profile as jprofile
from advntr_tpu.models import struct_compiler as jstruct
from advntr_tpu.models.reference_vntr import ReferenceVNTR as JRef
from advntr_tpu.utils import quality as jquality
from advntr_tpu_torch import dna
from advntr_tpu_torch.engine import coverage_bias as cov
from advntr_tpu_torch.engine import genotype as geno
from advntr_tpu_torch.engine import simulate as sim
from advntr_tpu_torch.io import bam, cram, fasta, sam
from advntr_tpu_torch.models import compiler as comp
from advntr_tpu_torch.models import graph, profile
from advntr_tpu_torch.models import struct_compiler as struct
from advntr_tpu_torch.models.reference_vntr import ReferenceVNTR
from advntr_tpu_torch.utils import quality

REF_PKG = Path(advntr_tpu.__file__).parent
OWN_PKG = Path(advntr_tpu_torch.__file__).parent

# every module copied from the reference; None: the text is the original's
# once the import lines are normalised.  The named, intended differences:
# - models/reference_vntr.py has none in its text: its two seams (the numpy
#   Viterbi and the segment splitter) are modules of the port's own, held
#   to their originals by test_seam_functions_equal_their_originals;
# - models/pattern_clustering.py: ``get_pattern_clusters`` fits scipy's
#   complete linkage and cuts it as sklearn does, where the original fits
#   sklearn; everything before that function is the original's, and
#   tests/test_torch_offline.py holds the clusters to sklearn's.
INTENDED = {
    "dna.py": None, "config.py": None,
    "utils/quality.py": None,
    "models/graph.py": None, "models/compiler.py": None,
    "models/struct_compiler.py": None, "models/profile.py": None,
    "models/msa.py": None, "models/reference_vntr.py": None,
    "models/db.py": None, "models/hmm_json.py": None,
    "io/bgzf.py": None, "io/bam.py": None, "io/sam.py": None,
    "io/fasta.py": None, "io/cram.py": None,
    "engine/genotype.py": None, "engine/coverage_bias.py": None,
    "engine/analytics.py": None,
    "engine/simulate.py": None, "engine/haplotyper.py": None,
    "engine/reference_editor.py": None, "engine/read_screens.py": None,
    "engine/evaluation.py": None,
    "models/annotation.py": None, "models/db_build.py": None,
    "models/homology.py": None,
    "models/pattern_clustering.py": "def get_pattern_clusters",
}
IMPORT_LINE = re.compile(r"^(\s*(?:from|import)\s+)advntr_tpu_torch(?=[\s.])",
                         re.M)


@pytest.mark.parametrize("module", sorted(INTENDED))
def test_copy_text_equals_original(module):
    original = (REF_PKG / module).read_text()
    copy = IMPORT_LINE.sub(r"\1advntr_tpu", (OWN_PKG / module).read_text())
    cut = INTENDED[module]
    if cut is not None:
        # compare what precedes the rewritten function, less the module
        # docstring, and hold the rewrite to what it is said to be
        tail = copy.split(cut)[1]
        sklearn = re.compile(r"^\s*from sklearn", re.M)
        assert sklearn.search(original.split(cut)[1])
        assert not sklearn.search(copy) and "linkage(" in tail
        original, copy = (text.split(cut)[0].split('"""\n', 1)[1]
                          for text in (original, copy))
    diff = [ln for ln in difflib.unified_diff(original.splitlines(),
                                              copy.splitlines(), lineterm="",
                                              n=0)]
    assert diff == []


def test_seam_functions_equal_their_originals():
    """The numpy Viterbi of reference_vntr.py's repeat finder, the numpy
    local alignment of ops/align.py, the host numpy parts of the
    posterior and Baum-Welch modules (``log_sub``, the M-step), the
    decoy scan of the training module and the finder's artifact padding
    are verbatim parts of modules the port does not copy whole; so is the
    NEG32 floor."""
    import inspect

    from advntr_tpu.engine import finder as jfinder
    from advntr_tpu.engine import training as jtraining
    from advntr_tpu.ops import align as jalign
    from advntr_tpu.ops import baum_welch as jbw
    from advntr_tpu.ops import posterior as jposterior
    from advntr_tpu.ops import viterbi as jviterbi
    from advntr_tpu_torch.engine import finder, training
    from advntr_tpu_torch.ops import align, baum_welch, posterior, viterbi
    pairs = [(viterbi.viterbi_numpy, jviterbi.viterbi_numpy),
             (align.local_align, jalign.local_align),
             (posterior.log_sub, jposterior.log_sub),
             (baum_welch.baum_welch_update, jbw.baum_welch_update),
             (training.rolling_kmer_codes, jtraining.rolling_kmer_codes),
             (training.simulate_false_filtered_reads,
              jtraining.simulate_false_filtered_reads),
             (finder._pad_artifact, jfinder._pad_artifact)]
    for own, ref in pairs:
        assert inspect.getsource(own) == inspect.getsource(ref), own.__name__
    assert viterbi.NEG32 == jviterbi.NEG32
    assert viterbi.NEG32.dtype == jviterbi.NEG32.dtype


def test_sparse_viterbi_equals_original():
    """``native_bridge.SparseViterbiModel`` over the port's copy of
    native/viterbi_sparse.cc: the C++ source equal to the original's, the
    class equal once its import line is normalised, its CSR tables equal
    the original's, and its logp the float64 oracle's on seeded reads of
    a model and on a junk read."""
    import inspect

    from advntr_tpu import native_bridge as jnative
    from advntr_tpu_torch import native_bridge as native
    assert (OWN_PKG / "csrc" / "viterbi_sparse.cc").read_text() == \
        (REF_PKG.parent / "native" / "viterbi_sparse.cc").read_text()
    text = IMPORT_LINE.sub(r"\1advntr_tpu",
                           inspect.getsource(native.SparseViterbiModel))
    assert text == inspect.getsource(jnative.SparseViterbiModel)
    units, left, right = ["CAGCAG", "CAGCAG", "CAACAG"], "ACGTTGCA", "TTACGGAT"
    trans, emis = jprofile.profile_for_repeats(units, 0.05)
    jg = jgraph.build_read_matcher(left, right, trans, emis, 3, 0.05)
    trans, emis = profile.profile_for_repeats(units, 0.05)
    g = graph.build_read_matcher(left, right, trans, emis, 3, 0.05)
    own, ref = native.SparseViterbiModel(g), jnative.SparseViterbiModel(jg)
    for field in ("names", "m", "silent_start", "start_index", "end_index"):
        assert getattr(own, field) == getattr(ref, field), field
    for field in ("in_edge_count", "in_transitions", "in_logw", "log_e"):
        np.testing.assert_array_equal(getattr(own, field),
                                      getattr(ref, field), err_msg=field)
    # the reference's library is not built here (tests/test_native_viterbi
    # builds it in place): the port's is held to the float64 oracle as
    # that test holds the original
    rng = random.Random(17)
    reads = ["ACGTTGCACAGCAGCAGCAGCAACAGTTACGGAT", "TTGCACAGCAGCAGCAGTTACG",
             "".join(rng.choice("ACGT") for _ in range(30))]
    for read in reads:
        codes = dna.encode(read)
        logp, names = own.viterbi(codes)
        assert logp == pytest.approx(comp.viterbi_full_graph(g, codes)[0],
                                     abs=1e-9), read
        assert names[0].endswith("-start") and names[-1].endswith("-end")


def test_scale_out_equals_original():
    """parallel/distributed.py's ``shard_loci`` and ``gather_results`` are
    verbatim; ``run_sharded_panel`` adds only ``device``; and
    parallel/mesh.py's ``panel_mesh`` factors every device count as the
    original factors the jax devices (tests/test_torch_mesh.py and
    test_torch_distributed.py run both end to end)."""
    import inspect

    import jax
    import torch

    from advntr_tpu.parallel import distributed as jdist
    from advntr_tpu.parallel import mesh as jmesh
    from advntr_tpu_torch.parallel import distributed, mesh
    for name in ("shard_loci", "gather_results"):
        assert inspect.getsource(getattr(distributed, name)) == \
            inspect.getsource(getattr(jdist, name)), name
    own = inspect.signature(distributed.run_sharded_panel).parameters
    ref = inspect.signature(jdist.run_sharded_panel).parameters
    assert list(own) == list(ref) + ["device"]
    assert own["device"].default == "cuda"
    for n in range(1, 9):
        for group_size in (1, 2, 3, 4, 6, 8, 16):
            for batch in (1, 2, 8, 12, 512):
                got = mesh.panel_mesh(group_size, batch,
                                      devices=[torch.device("cpu")] * n)
                want = jmesh.panel_mesh(group_size, batch,
                                        devices=jax.devices()[:n])
                assert (got is None) == (want is None)
                if got is not None:
                    assert (got.n_loci, got.n_reads) == \
                        (want.shape["loci"], want.shape["reads"])


def test_clean_neg_equals_original():
    """``clean_neg`` is the original's numpy with the upload to a torch
    device in place of jnp.asarray: equal float32 tables."""
    import torch

    from advntr_tpu.ops import posterior as jposterior
    from advntr_tpu_torch.ops import posterior
    rng = np.random.default_rng(13)
    x = rng.normal(size=(7, 9)) * 50
    x[rng.random((7, 9)) < 0.3] = -np.inf
    got = posterior.clean_neg(x, torch.device("cpu"))
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jposterior.clean_neg(x)))


def test_version_equals_reference():
    assert advntr_tpu_torch.__version__ == advntr_tpu.__version__


# ---- models: compiled artifact and structured model, array by array -------

LOCI = [
    (["CAGCAG", "CAGCAG", "CAACAG"], "ACGTTGCA", "TTACGGAT", 3),
    (["CGCGGGGCGGGG"] * 3, "ACGTACTGACGATCGATT", "TTACGGATGCAGTACGTA", 5),
    (["ACGTAC", "ACGTTAC", "ACGAC"], "GATTACAGATTACAGATT", "CCATGGCCATGG", 9),
]


def _assert_fields_equal(got, want):
    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(want)]
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("units,left,right,copies", LOCI)
def test_compiled_models_equal_reference(units, left, right, copies):
    built = []
    for prof, gr, cp, st in ((profile, graph, comp, struct),
                             (jprofile, jgraph, jcomp, jstruct)):
        trans, emis = prof.profile_for_repeats(list(units), 0.05)
        g = gr.build_read_matcher(left, right, trans, emis, copies, 0.05)
        art = cp.compile_graph(g)
        sm = st.build_structured(g, art)
        padded = st.pad_structured(sm, art, 64 * (sm.P // 64 + 1),
                                   8 * -(-sm.C // 8))
        built.append((trans, emis, art, sm, padded))
    own, ref = built
    assert own[0] == ref[0] and own[1] == ref[1]
    for got, want in zip(own[2:], ref[2:]):
        _assert_fields_equal(got, want)


def test_find_genotype_equals_reference():
    rng = random.Random(3)
    for _ in range(40):
        counts = [rng.choice([2, 3, 5, 5, 7]) for _ in range(rng.randint(0, 25))]
        for haploid in (False, True):
            assert geno.find_genotype(counts, haploid, 0.05) == \
                jgeno.find_genotype(counts, haploid, 0.05)


def test_dna_encoding_and_reverse_complement():
    rng = random.Random(4)
    seqs = ["".join(rng.choice("ACGTN") for _ in range(rng.randint(1, 90)))
            for _ in range(50)]
    for s in seqs:
        np.testing.assert_array_equal(dna.encode(s), jdna.encode(s))
        assert dna.revcomp(s) == jdna.revcomp(s)
        assert dna.has_n(s) == jdna.has_n(s)
        np.testing.assert_array_equal(dna.revcomp_codes(dna.encode(s)),
                                      jdna.revcomp_codes(jdna.encode(s)))
    rows = [dna.encode(s) for s in seqs]
    for got, want in zip(dna.pad_batch(rows, pad_to=64, multiple=32),
                         jdna.pad_batch(rows, pad_to=64, multiple=32)):
        np.testing.assert_array_equal(got, want)


def test_quality_filter_equals_reference():
    rng = random.Random(5)
    for _ in range(200):
        quals = [rng.randint(0, 40) for _ in range(rng.randint(1, 60))]
        args = (rng.randint(0, 60), quals, rng.choice([0, 20]),
                rng.choice([0, 15, 30]), rng.choice([0.1, 0.5, 1.0]))
        assert quality.is_low_quality_read(*args) == \
            jquality.is_low_quality_read(*args)


# ---- alignment files: what one package writes, both read alike ------------

_rng = random.Random(11)
CHROM = "".join(_rng.choice("ACGT") for _ in range(4000))


def _reads(mod):
    rng = random.Random(6)
    reads = []
    for i in range(12):
        start = 100 + 150 * i
        seq = CHROM[start:start + 80]
        reads.append(mod.BamRead(f"m{i}", 16 * (i % 2), 0, start, 60,
                                 [(0, 80)], seq,
                                 [rng.randint(2, 40) for _ in seq], "chr21"))
    for i in range(5):
        seq = "".join(rng.choice("ACGT") for _ in range(60 + i))
        reads.append(mod.BamRead(f"u{i}", 4, -1, -1, 0, [], seq,
                                 [30] * len(seq)))
    return reads


def _as_tuples(records):
    return [(r.query_name, r.flag, r.reference_name, r.reference_start,
             r.mapq, list(r.cigar), r.seq, list(r.qual or []))
            for r in records]


def test_bam_round_trip_equals_reference(tmp_path):
    paths = {}
    for name, mod in (("own", bam), ("ref", jbam)):
        paths[name] = str(tmp_path / f"{name}.bam")
        with mod.BamWriter(paths[name], ["chr21"], [len(CHROM)]) as w:
            for r in _reads(mod):
                w.write(r)
        mod.build_bai(paths[name])
    assert Path(paths["own"]).read_bytes() == Path(paths["ref"]).read_bytes()
    assert Path(paths["own"] + ".bai").read_bytes() == \
        Path(paths["ref"] + ".bai").read_bytes()
    with bam.BamReader(paths["ref"]) as own, \
            jbam.BamReader(paths["own"]) as ref:
        assert _as_tuples(own) == _as_tuples(ref)
        assert _as_tuples(own.fetch("chr21", 400, 900)) == \
            _as_tuples(ref.fetch("chr21", 400, 900))
        assert _as_tuples(own.fetch_unmapped()) == \
            _as_tuples(ref.fetch_unmapped())


def test_sam_round_trip_equals_reference(tmp_path):
    path = str(tmp_path / "reads.sam")
    with open(path, "w") as fh:
        fh.write("@HD\tVN:1.6\tSO:coordinate\n")
        fh.write(f"@SQ\tSN:chr21\tLN:{len(CHROM)}\n")
        for r in _reads(bam):
            cigar = "".join(f"{n}M" for _, n in r.cigar) or "*"
            rname = "chr21" if r.reference_id >= 0 else "*"
            qual = "".join(chr(q + 33) for q in r.qual)
            fh.write("\t".join([r.query_name, str(r.flag), rname,
                                str(r.reference_start + 1), str(r.mapq),
                                cigar, "*", "0", "0", r.seq, qual]) + "\n")
    with sam.open_alignment(path) as own, jsam.open_alignment(path) as ref:
        assert type(own).__module__ == "advntr_tpu_torch.io.sam"
        assert own.references == ref.references == ["chr21"]
        assert _as_tuples(own) == _as_tuples(ref)
        assert _as_tuples(own.fetch_unmapped()) == \
            _as_tuples(ref.fetch_unmapped())
        assert len(_as_tuples(own.fetch("chr21", 400, 900))) > 0
        assert _as_tuples(own.fetch("chr21", 400, 900)) == \
            _as_tuples(ref.fetch("chr21", 400, 900))


def test_cram_round_trip_equals_reference(tmp_path):
    fa = str(tmp_path / "ref.fa")
    fasta.write_fasta(fa, [("chr21", CHROM)])
    assert list(fasta.read_fasta(fa)) == list(jfasta.read_fasta(fa))
    paths = {}
    for name, mod, reads_mod in (("own", cram, bam), ("ref", jcram, jbam)):
        paths[name] = str(tmp_path / f"{name}.cram")
        with mod.CramWriter(paths[name], ["chr21"], [len(CHROM)],
                            reference_seqs={"chr21": CHROM},
                            records_per_container=7) as w:
            for r in _reads(reads_mod):
                w.write(r)
    assert Path(paths["own"]).read_bytes() == Path(paths["ref"]).read_bytes()
    with sam.open_alignment(paths["ref"], fa) as own, \
            jsam.open_alignment(paths["own"], fa) as ref:
        assert type(own).__module__ == "advntr_tpu_torch.io.cram"
        got, want = _as_tuples(own), _as_tuples(ref)
        assert got == want and len(got) == 17
        assert [t[6] for t in got] == [r.seq for r in _reads(bam)]


# ---- the repeat finder, coverage bias, read simulation --------------------

def test_repeat_finder_segments_equal_reference():
    rng = random.Random(8)
    for pattern, copies in (("CAGCAG", 4), ("CGCGGGGCGGGG", 3),
                            ("ACGTTAC", 5)):
        region = "".join(
            pattern if rng.random() < 0.6 else
            pattern[:rng.randint(2, len(pattern))] for _ in range(copies))
        own = ReferenceVNTR(1, pattern, 0, "chr1", estimated_repeats=copies)
        ref = JRef(1, pattern, 0, "chr1", estimated_repeats=copies)
        got = own.find_repeat_segments(region)
        assert got == ref.find_repeat_segments(region)
        assert "".join(got) in region and len(got) >= 1


def test_coverage_bias_correction_equals_reference(tmp_path):
    path = str(tmp_path / "cov.bam")
    rng = random.Random(9)
    with bam.BamWriter(path, ["chr21"], [len(CHROM)]) as w:
        for start in sorted(rng.randint(0, len(CHROM) - 120)
                            for _ in range(400)):
            seq = CHROM[start:start + 100]
            w.write(bam.BamRead(f"r{start}", 0, 0, start, 60, [(0, 100)],
                                seq, [30] * 100))
    maps = []
    for mod in (cov, jcov):
        detector = mod.CoverageBiasDetector(
            path, reference_sequences={"chr21": CHROM})
        maps.append(detector.get_gc_content_coverage_map())
    assert maps[0] == maps[1] and maps[0]
    own_ref = ReferenceVNTR(1, "CGCGGG", 0, "chr21")
    own_ref.repeat_segments = ["CGCGGG"] * 3
    gc_bin = cov.CoverageCorrector.get_gc_bin_index(
        cov.get_gc_content("CGCGGG" * 3))
    gc_map = dict(maps[0])
    gc_map.setdefault(gc_bin, [12.0, 15.0])
    assert cov.CoverageCorrector(gc_map).get_scaled_coverage(own_ref, 90.0) \
        == jcov.CoverageCorrector(gc_map).get_scaled_coverage(own_ref, 90.0)


def test_simulated_reads_equal_reference():
    left, right = "ACGT" * 40, "TTGCA" * 30
    for seed in (0, 5):
        got = sim.simulate_diploid_reads(left, "CAGCAG", 2, 5, right,
                                         read_length=100, coverage=10,
                                         error_rate=0.01, seed=seed)
        want = jsim.simulate_diploid_reads(left, "CAGCAG", 2, 5, right,
                                           read_length=100, coverage=10,
                                           error_rate=0.01, seed=seed)
        assert got == want
    own = ReferenceVNTR(1, "CAGCAG", 0, "chr1")
    own.repeat_segments = ["CAGCAG"] * 4
    own.left_flanking_region, own.right_flanking_region = left, right
    assert sim.simulate_true_reads(own, 60, random.Random(2)) == \
        jsim.simulate_true_reads(own, 60, random.Random(2))


def test_haplotyper_and_host_alignment_equal_reference():
    """The copied haplotyper and the copied numpy alignment functions give
    the originals' results on seeded long-read windows."""
    from advntr_tpu.engine import haplotyper as jhap
    from advntr_tpu.ops import align as jalign
    from advntr_tpu_torch.engine import haplotyper as hap
    from advntr_tpu_torch.ops import align
    rng = random.Random(12)
    left = "".join(rng.choice("ACGT") for _ in range(60))
    right = "".join(rng.choice("ACGT") for _ in range(60))
    reads = [sim.mutate(left + "CATCAGTTGA" * copies + right, 0.01, rng)
             for copies in (4, 4, 4, 7, 7, 7, 4, 7)]
    for k in (1, 2):
        assert hap.PacBioHaplotyper(reads).get_error_corrected_haplotypes(k) \
            == jhap.PacBioHaplotyper(reads).get_error_corrected_haplotypes(k)
    assert hap.PacBioHaplotyper(reads[:1]).get_error_corrected_haplotypes() \
        == reads[:1]
    for read in reads[:4]:
        for probe in (left, right, right[::-1]):
            assert align.local_align(read, probe) == \
                jalign.local_align(read, probe)
    assert align.global_align_score(left, reads[0][:70]) == \
        jalign.global_align_score(left, reads[0][:70])
