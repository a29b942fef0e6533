"""The port's offline analysis modules (ROADMAP A14) against the
reference's: the equivalents of tests/test_offline_analysis.py and
tests/test_evaluation.py, each output equal to the reference's on the same
seeded inputs.  ``get_pattern_clusters`` is the one module that is not a
verbatim copy: scipy's complete linkage and sklearn's cut in place of
sklearn's fit, held to sklearn's clusters in order."""

import random

import numpy as np
import pytest
import torch

from advntr_tpu.engine import evaluation as jeval
from advntr_tpu.engine import read_screens as jscreens
from advntr_tpu.engine import reference_editor as jeditor
from advntr_tpu.models import annotation as jannot
from advntr_tpu.models import db_build as jdb_build
from advntr_tpu.models import homology as jhom
from advntr_tpu.models import pattern_clustering as jclust
from advntr_tpu.models.db import load_unique_vntrs_data as jload
from advntr_tpu.models.reference_vntr import ReferenceVNTR as JRef
from advntr_tpu_torch.engine import evaluation
from advntr_tpu_torch.engine import read_screens as screens
from advntr_tpu_torch.engine import reference_editor as editor
from advntr_tpu_torch.models import annotation as annot
from advntr_tpu_torch.models import db_build
from advntr_tpu_torch.models import homology as hom
from advntr_tpu_torch.models import pattern_clustering as clust
from advntr_tpu_torch.models.db import load_unique_vntrs_data
from advntr_tpu_torch.models.reference_vntr import ReferenceVNTR

# the suite runs test files in parallel worker processes: one torch thread
# each keeps them from oversubscribing the cores
torch.set_num_threads(1)


def _rand(rng, n):
    return "".join(rng.choice("ACGT") for _ in range(n))


def _mutate(rng, unit, edits):
    p = list(unit)
    for _ in range(edits):
        op, pos = rng.random(), rng.randrange(len(p))
        if op < 0.5:
            p[pos] = rng.choice("ACGT")
        elif op < 0.75 and len(p) > 2:
            del p[pos]
        else:
            p.insert(pos, rng.choice("ACGT"))
    return "".join(p)


# ---- pattern clustering ------------------------------------------------------

def test_pattern_clusters_two_groups():
    patterns = ["ACGTACGT", "ACGTACGA", "TTTTGGGG", "TTTTGGGC"]
    clusters = clust.get_pattern_clusters(patterns)
    assert clusters == jclust.get_pattern_clusters(patterns)
    as_sets = sorted([sorted(c) for c in clusters])
    assert ["ACGTACGA", "ACGTACGT"] in as_sets
    assert ["TTTTGGGC", "TTTTGGGG"] in as_sets


def test_pattern_clusters_equal_sklearn_on_200_seeded_sets():
    """1-10 units of one or two motifs with up to three edits each:
    integer edit distances, so ties are common; the clusters and their
    order equal the reference's sklearn fit."""
    rng = random.Random(20)
    ties = 0
    for _ in range(200):
        motifs = [_rand(rng, rng.randint(3, 12))
                  for _ in range(rng.randint(1, 2))]
        patterns = [_mutate(rng, rng.choice(motifs), rng.randint(0, 3))
                    for _ in range(rng.randint(1, 10))]
        assert clust.get_pattern_clusters(patterns) == \
            jclust.get_pattern_clusters(patterns), patterns
        dist = clust.get_distance_matrix(patterns)
        upper = dist[np.triu_indices(len(patterns), k=1)]
        ties += len(upper) != len(set(upper.tolist()))
    assert ties > 100


def test_cut_labels_equal_sklearn():
    """Every k of a seeded set: ``_hc_cut``'s labels are sklearn's."""
    from sklearn.cluster import AgglomerativeClustering
    rng = random.Random(21)
    for _ in range(30):
        patterns = [_mutate(rng, "CAGGTACA", rng.randint(0, 4))
                    for _ in range(rng.randint(2, 9))]
        dist = clust.get_distance_matrix(patterns)
        children = clust._complete_linkage_children(dist)
        for k in range(1, len(patterns) + 1):
            want = AgglomerativeClustering(
                metric="precomputed", linkage="complete",
                n_clusters=k).fit(dist).labels_
            np.testing.assert_array_equal(
                clust._hc_cut(k, children, len(patterns)), want)


def test_elbow_and_distances_equal_reference():
    rng = random.Random(22)
    for _ in range(20):
        patterns = [_mutate(rng, "GGCACTTA", rng.randint(0, 3))
                    for _ in range(6)]
        np.testing.assert_array_equal(clust.get_distance_matrix(patterns),
                                      jclust.get_distance_matrix(patterns))
        for s, t in zip(patterns, patterns[1:]):
            assert clust.get_sequence_distance(s, t, True) == \
                jclust.get_sequence_distance(s, t, True)
        curve = [rng.random() for _ in range(rng.randint(1, 8))]
        assert clust.get_elbow_point_index(curve) == \
            jclust.get_elbow_point_index(curve)


# ---- homology ----------------------------------------------------------------

def _locus(cls, vid, pattern, left, right, chrom="chr1", start=0):
    r = cls(vid, pattern, start, chrom)
    r.left_flanking_region = left
    r.right_flanking_region = right
    r.repeat_segments = [pattern]
    return r


def test_homologous_vntrs():
    for cls, mod in ((ReferenceVNTR, hom), (JRef, jhom)):
        a = _locus(cls, 1, "CAGCAGCAG", "A" * 30, "G" * 30)
        b = _locus(cls, 2, "CAGCAGCAG", "A" * 30, "G" * 30)
        c = _locus(cls, 3, "TTGGCCTTAA", "CGTA" * 8, "TACG" * 8)
        assert mod.is_homologous_vntr(a, b)
        assert not mod.is_homologous_vntr(a, c)
        assert mod.vntr_graph([a, b, c]) == ([1, 2, 3], [(1, 2)])


def test_homology_screens_equal_reference():
    """Seeded loci, some of them mutated copies of others: the pairwise
    flags, the graph and the similar-region screen equal the
    reference's."""
    rng = random.Random(23)
    specs = []
    for vid in range(8):
        if vid % 3 == 2:
            _, pattern, left, right = specs[vid - 1]
            left, right = _mutate(rng, left, 3), _mutate(rng, right, 3)
        else:
            pattern = _rand(rng, rng.randint(6, 12))
            left, right = _rand(rng, 40), _rand(rng, 40)
        specs.append((vid, pattern, left, right))
    # locus 0's structure planted on chr2, a copy of locus 1's on chr1
    # within 10 kb of it (the locus itself, which the screen skips)
    planted = lambda s: s[2][-30:] + s[1] + s[3][:30]
    chrom = _rand(rng, 3000)
    refs = {"chr1": chrom[:400] + planted(specs[1]) + chrom[400:],
            "chr2": chrom[:1000] + planted(specs[0]) + chrom[1000:]}
    got, want = [], []
    for cls, mod, out in ((ReferenceVNTR, hom, got), (JRef, jhom, want)):
        loci = [_locus(cls, vid, p, l, r, start=500 * vid)
                for vid, p, l, r in specs]
        mod.identify_homologous_vntrs(loci)
        out.append([v.has_homologous for v in loci])
        out.append(mod.vntr_graph(loci))
        out.append([mod.find_similar_region_for_vntr(v, refs)
                    for v in loci[:3]])
        out.append(mod.vntr_structure(loci[1], margin=10))
    assert got == want
    assert any(got[0]) and got[2][:2] == [True, False]


# ---- annotation --------------------------------------------------------------

def _tracks(tmp_path):
    files = {
        "exons": "chr1\t100\t200\tNM_0001.2\t0\t+\n"
                 "chr1\t7000\t7100\tNM_0003.1\t0\t+\n",
        "genes": "chr1\t100\t5000\tNM_0001.2\t0\t+\n"
                 "chr1\t6500\t8000\tNM_0003.1\t0\t+\n"
                 "chr1\t9000\t9500\tNM_0002.1\t0\t-\n"
                 "chr2\t300\t900\tNR_0004.1\t0\t+\n",
        "introns": "chr1\t200\t1000\tNM_0001.2\t0\t+\n",
        "utr5": "chr1\t6500\t6600\tNM_0003.1\t0\t+\n",
        "utr3": "chr1\t7900\t8000\tNM_0003.1\t0\t+\n",
        "empty": "",
        "map": "NM_0001 GENE1\nNM_0002 GENE2\nNM_0003 GENE3\n",
    }
    paths = {}
    for name, text in files.items():
        paths[name] = tmp_path / f"{name}.txt"
        paths[name].write_text(text)
    return paths


def _assigner(mod, paths):
    read = lambda name: mod.read_bed_track(str(paths[name]))
    return mod.AnnotationAssigner(
        genes=read("genes"), exons=read("exons"), introns=read("introns"),
        utr3=read("utr3"), utr5=read("utr5"),
        name_mapping=mod.read_name_mapping(str(paths["map"])))


def test_annotation_precedence(tmp_path):
    assigner = _assigner(annot, _tracks(tmp_path))
    assert assigner.annotate("chr1", 150, 160) == ("GENE1", "Coding")
    assert assigner.annotate("chr1", 300, 350) == ("GENE1", "Intron")
    assert assigner.annotate("chr1", 9600, 9650) == ("GENE2", "Promoter")
    assert assigner.annotate("chr1", 20000, 20100) == ("None", "None")
    assert assigner.is_close_to_gene("chr1", 5500, 5600)


def test_annotation_equals_reference(tmp_path):
    paths = _tracks(tmp_path)
    own, ref = _assigner(annot, paths), _assigner(jannot, paths)
    rng = random.Random(24)
    for _ in range(500):
        chrom = rng.choice(["chr1", "chr2", "chr3"])
        start = rng.randint(0, 11000)
        end = start + rng.randint(0, 400)
        assert own.annotate(chrom, start, end) == \
            ref.annotate(chrom, start, end)
        assert own.is_close_to_gene(chrom, start, end) == \
            ref.is_close_to_gene(chrom, start, end)
    assert annot.read_bed_track(str(paths["genes"])) == \
        jannot.read_bed_track(str(paths["genes"]))


# ---- reference editor and read screens ------------------------------------

def test_reference_editor():
    chrom = "A" * 2000 + "CAGCAGCAG" + "G" * 2000
    ref = ReferenceVNTR(1, "CAG", 2000, "chr1")
    ref.repeat_segments = ["CAG"] * 3
    edited = editor.reference_with_indel(ref, chrom, 4, insertion=True,
                                         inserted_bp="T", flank=10)
    assert edited == "A" * 10 + "CAGCTAGCAG" + "G" * 10
    expanded = editor.reference_with_repeat_count(ref, chrom, 5, flank=10)
    assert expanded == "A" * 10 + "CAG" * 5 + "G" * 10


def test_reference_editor_equals_reference(tmp_path):
    rng = random.Random(25)
    for _ in range(40):
        units = [_mutate(rng, "CAGGTC", rng.randint(0, 2))
                 for _ in range(rng.randint(1, 6))]
        left, right = _rand(rng, 300), _rand(rng, 300)
        chrom = left + "".join(units) + right
        refs = []
        for cls in (ReferenceVNTR, JRef):
            r = cls(1, "CAGGTC", len(left), "chr1")
            r.repeat_segments = units
            refs.append(r)
        pos = rng.randint(0, len("".join(units)) - 1)
        ins, flank = rng.random() < 0.5, rng.randint(1, 320)
        k = rng.randint(0, 12)
        assert editor.reference_with_indel(refs[0], chrom, pos, ins, "G",
                                           flank) == \
            jeditor.reference_with_indel(refs[1], chrom, pos, ins, "G",
                                         flank)
        for f in (None, flank):
            assert editor.reference_with_repeat_count(
                refs[0], chrom, k, flank=f) == \
                jeditor.reference_with_repeat_count(refs[1], chrom, k,
                                                    flank=f)
    editor.write_reference(chrom, "chr1", str(tmp_path / "own.fa"))
    jeditor.write_reference(chrom, "chr1", str(tmp_path / "ref.fa"))
    assert (tmp_path / "own.fa").read_bytes() == \
        (tmp_path / "ref.fa").read_bytes()


def test_read_screens_equal_reference():
    rng = random.Random(26)
    query = "CAGGTACAGT"
    reads = []
    for _ in range(60):
        kind = rng.random()
        if kind < 0.3:
            read = _rand(rng, 20) + query * 2 + _rand(rng, 20)
        elif kind < 0.5:
            read = _rand(rng, 30) + _mutate(rng, query, 2) + _rand(rng, 30)
        else:
            read = _rand(rng, rng.randint(5, 80))
        reads.append(read.replace("T", "N") if kind > 0.95 else read)
    assert screens.composition_screen(query, reads) == \
        jscreens.composition_screen(query, reads)
    for k in (4, 6, 9):
        assert screens.kmer_screen(query, k, reads) == \
            jscreens.kmer_screen(query, k, reads)
    for read in reads[:20]:
        assert screens.composition_window_match(query, read, 2) == \
            jscreens.composition_window_match(query, read, 2)
    np.testing.assert_array_equal(screens.nucleotide_map("ACGTTNA"),
                                  jscreens.nucleotide_map("ACGTTNA"))


# ---- DB construction ---------------------------------------------------------

def test_db_build_from_vntrseek_equals_reference(tmp_path):
    """A seeded chromosome with planted arrays and a VNTRseek table
    (out-of-range motifs, an overlapping pair, another chromosome): the
    loci each package parses, decomposes and saves are equal."""
    rng = random.Random(27)
    chrom, lines = _rand(rng, 800), []
    for i in range(5):
        unit = _rand(rng, rng.choice([6, 9, 12]))
        copies = rng.randint(3, 6)
        lines.append(f"{copies - 2}.0 x {unit} chr1 {len(chrom) + 1}")
        chrom += "".join(_mutate(rng, unit, rng.randint(0, 1))
                         for _ in range(copies)) + _rand(rng, 700)
    lines.append(f"3.0 x ACG chr1 {len(chrom) - 300}")        # motif < 6
    lines.append(f"2.0 x {'A' * 101} chr1 {len(chrom) - 200}")  # > 100
    lines.append(f"3.0 x CAGGTA chr2 {len(chrom) - 100}")
    lines.insert(2, lines[1].replace(lines[1].split()[-1],
                                     str(int(lines[1].split()[-1]) + 6)))
    table = tmp_path / "vntrseek.txt"
    table.write_text("\n".join(lines) + "\n")
    saved = []
    for mod, load in ((db_build, load_unique_vntrs_data),
                      (jdb_build, jload)):
        db = str(tmp_path / f"{mod.__name__.split('.')[0]}.db")
        n = mod.build_database_from_vntrseek(str(table), chrom, db,
                                             chromosome="chr1")
        saved.append((n, [(v.id, v.pattern, v.start_point, v.chromosome,
                           v.repeat_segments, v.left_flanking_region,
                           v.right_flanking_region, v.estimated_repeats)
                          for v in load(db)]))
    assert saved[0] == saved[1]
    assert saved[0][0] >= 3
    own = db_build.load_unprocessed_vntrseek_data(str(table), chrom)
    ref = jdb_build.load_unprocessed_vntrseek_data(str(table), chrom)
    assert [(v.id, v.pattern, v.start_point, v.estimated_repeats)
            for v in own] == [(v.id, v.pattern, v.start_point,
                               v.estimated_repeats) for v in ref]


# ---- evaluation --------------------------------------------------------------

def test_compare_genotypes():
    truth = {1: (2, 3), 2: (4, 4), 3: (1, 5), 4: (2, 2)}
    called = {1: (3, 2), 2: (4, 5), 4: "Error"}
    cmp = evaluation.compare_genotypes(called, truth)
    assert (cmp.correct, cmp.incorrect, cmp.missing, cmp.errors) == \
        (1, 1, 1, 1)
    assert cmp.accuracy == 0.25
    ref = jeval.compare_genotypes(called, truth)
    assert (cmp.n_loci, cmp.mismatches) == (ref.n_loci, ref.mismatches)


def test_recruitment_metrics():
    args = (["a", "b", "c"], ["b", "c", "d"], ["a", "b", "c", "d", "e"])
    m = evaluation.recruitment_metrics(*args)
    assert m["tp"] == 2 and m["fp"] == 1 and m["fn"] == 1
    assert m == jeval.recruitment_metrics(*args)
    assert evaluation.recruitment_metrics([], [], []) == \
        jeval.recruitment_metrics([], [], [])


def test_consensus_and_reports_equal_reference():
    units = ["ACGTAC", "ACGTAC", "ACCTAC", "ACGTAC"]
    cons = evaluation.consensus_of_units(units)
    assert cons == "ACGTAC" == jeval.consensus_of_units(units)
    report = evaluation.pairwise_alignment_report("ACCTAC", cons)
    assert "||" in report and "score:" in report
    assert report == jeval.pairwise_alignment_report("ACCTAC", cons)
    rng = random.Random(28)
    for _ in range(20):
        units = [_mutate(rng, "GATTACA", rng.randint(0, 2))
                 for _ in range(rng.randint(0, 6))]
        assert evaluation.consensus_of_units(units) == \
            jeval.consensus_of_units(units)
    seq = "ACGTTGCA" + "CAGCAG" * 3 + "TTACGGAT"
    states = (["unit_start_1"] + ["M%d_1" % i for i in range(1, 7)]
              + ["unit_end_1"]) * 3
    assert evaluation.locus_alignment_report(seq, states) == \
        jeval.locus_alignment_report(seq, states)


def _locus_for_sweeps(cls, rng_seed=3):
    rng = random.Random(rng_seed)
    ref = cls(1, "CAGCAGCAG", 100, "chr1")
    ref.repeat_segments = ["CAGCAGCAG"] * 4
    ref.left_flanking_region = _rand(rng, 200)
    ref.right_flanking_region = _rand(rng, 200)
    return ref


def test_compare_recruitment_methods_equals_reference():
    def methods(ref):
        hap = (ref.left_flanking_region + ref.pattern * 4
               + ref.right_flanking_region)
        kmers = {hap[i:i + 15] for i in range(len(hap) - 14)}
        return {
            "kmer": lambda reads: [
                i for i, r in enumerate(reads)
                if any(r[j:j + 15] in kmers
                       for j in range(0, len(r) - 14, 5))],
            "mask": lambda reads: [i % 3 == 0 for i in range(len(reads))],
            "null": lambda reads: []}

    outs = []
    for cls, mod in ((ReferenceVNTR, evaluation), (JRef, jeval)):
        ref = _locus_for_sweeps(cls)
        outs.append(mod.compare_recruitment_methods(
            ref, methods(ref), n_true=40, read_length=100, seed=7))
    assert outs[0] == outs[1]
    assert outs[0]["kmer"]["recall"] > 0.9
    assert outs[0]["kmer"]["precision"] > 0.9
    assert outs[0]["null"]["recall"] == 0.0


def test_per_locus_accuracy_sweep():
    truth = {1: (2, 3), 2: (4, 4), 3: (5, 6)}

    def run_locus(ref):
        if ref.id == 3:
            raise RuntimeError("boom")
        return {1: (3, 2), 2: (4, 5)}[ref.id]

    sweeps = [mod.per_locus_accuracy_sweep(
        run_locus, [cls(i, "CAG", 0, "chr1") for i in range(1, 4)], truth)
        for cls, mod in ((ReferenceVNTR, evaluation), (JRef, jeval))]
    assert sweeps[0] == sweeps[1]
    statuses = {r["vid"]: r["status"] for r in sweeps[0]["rows"]}
    assert statuses[1] == "ok" and statuses[2] == "mismatch"
    assert statuses[3].startswith("error")
    assert abs(sweeps[0]["accuracy"] - 1 / 3) < 1e-9


def test_mutated_reference_sweep_equals_reference():
    """Edit reference -> simulate -> genotype -> compare, with the port's
    finder on the CPU (its plain twins) against the reference's finder:
    the same rows, every count called (k, k)."""
    from advntr_tpu_torch.config import Config
    from advntr_tpu_torch.engine.finder import VNTRFinder

    rng = random.Random(3)
    pattern = "ACGGTCAGT"
    left, right = _rand(rng, 400), _rand(rng, 400)
    chromosome = left + pattern * 5 + right
    sweeps = []
    for cls, mod in ((ReferenceVNTR, evaluation), (JRef, jeval)):
        ref = cls(77, pattern, len(left), "chr1")
        ref.repeat_segments = [pattern] * 5
        ref.left_flanking_region = left
        ref.right_flanking_region = right
        ref.estimated_repeats = 5
        kw = {}
        if mod is evaluation:
            kw["finder"] = VNTRFinder(ref, Config(), device="cpu")
        sweeps.append(mod.mutated_reference_sweep(
            ref, chromosome, desired_counts=[3, 4, 6], coverage=30,
            read_length=100, seed=5, **kw))
    own, want = sweeps
    assert own["rows"] == want["rows"]
    assert own["comparison"].accuracy == 1.0, own["rows"]
    for row in own["rows"]:
        assert row["called"] == (row["desired"], row["desired"])
        assert row["spanning"] > 0


def test_sweep_finder_defaults_to_the_card(monkeypatch):
    """With no finder given, the sweep builds the port's VNTRFinder on its
    default device, ``cuda``: the CPU is taken only when asked for."""
    from advntr_tpu_torch.engine import finder as finder_mod
    built = []

    class Stop(Exception):
        pass

    def fake(ref, config, *a, **kw):
        built.append(kw.get("device", "cuda"))
        raise Stop

    monkeypatch.setattr(finder_mod, "VNTRFinder", fake)
    with pytest.raises(Stop):
        evaluation.mutated_reference_sweep(_locus_for_sweeps(ReferenceVNTR),
                                           "A" * 1000, [2])
    assert built == ["cuda"]
