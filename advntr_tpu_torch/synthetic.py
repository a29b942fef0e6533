"""Seeded synthetic loci, reads and panels for the port's tests and its
on-card smoke run.  Host-only: every model and read comes from this
package's copies of the reference's host model code, from fixed seeds, so
the port and the reference score the same inputs."""

from __future__ import annotations

import copy
import os
import random

from advntr_tpu_torch import dna
from advntr_tpu_torch.engine.simulate import (haplotype_sequence, mutate,
                                              simulate_diploid_reads,
                                              simulate_pacbio_reads)
from advntr_tpu_torch.io.bam import BamRead, BamWriter, build_bai
from advntr_tpu_torch.models.bank import (copies_for_hmm, model_key,
                                          read_matcher)
from advntr_tpu_torch.models.compiler import compile_graph
from advntr_tpu_torch.models.db import (create_vntrs_database,
                                  save_reference_vntr_to_database)
from advntr_tpu_torch.models.graph import StateDef, build_read_matcher
from advntr_tpu_torch.models.profile import profile_for_repeats
from advntr_tpu_torch.models.reference_vntr import ReferenceVNTR
from advntr_tpu_torch.models.struct_compiler import (build_structured,
                                                     pad_structured)

CSTB_PATTERN = "CGCGGGGCGGGG"   # the CSTB dodecamer


def rand_seq(seed: int, n: int) -> str:
    rng = random.Random(seed)
    return "".join(rng.choice("ACGT") for _ in range(n))


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def padded_structured(graph, art, pos_bucket: int = 64,
                      unit_bucket: int = 8):
    """The structured model of a compiled read-matcher graph, padded like
    the engine's cache pads it (P to a bucket above P, C to a multiple of
    ``unit_bucket``)."""
    sm = build_structured(graph, art)
    return pad_structured(sm, art, round_up(sm.P + 1, pos_bucket),
                          round_up(sm.C, unit_bucket))


def locus_model(units, left: str, right: str, copies: int,
                err: float = 0.05, pos_bucket: int = 64,
                unit_bucket: int = 8):
    """(art, padded sm) of a read-matcher model."""
    trans, emis = profile_for_repeats(list(units), err)
    g = build_read_matcher(left, right, trans, emis, copies, err)
    art = compile_graph(g)
    return art, padded_structured(g, art, pos_bucket, unit_bucket)


def build_cstb_locus(read_length: int = 150):
    """The production-shape locus of the kernel cell: the CSTB dodecamer
    x3 between random ``read_length`` bp flanks (seed 42), error rate
    0.05.  Returns (graph, art, left, right, pattern); with the engine's
    padding at 150 bp it has n_states 927, P 512, C 16, nb 18."""
    rng = random.Random(42)
    left = "".join(rng.choice("ACGT") for _ in range(read_length))
    right = "".join(rng.choice("ACGT") for _ in range(read_length))
    copies = copies_for_hmm(CSTB_PATTERN, read_length)
    trans, emis = profile_for_repeats([CSTB_PATTERN] * 3, 0.05)
    graph = build_read_matcher(left, right, trans, emis, copies, 0.05)
    return graph, compile_graph(graph), left, right, CSTB_PATTERN


def refused_topology(graph):
    """A copy of a read-matcher graph with one more emitting state, an
    insert taken with probability 0.01 between the first two prefix match
    states: a topology the structured extractor refuses (its states no
    longer fill the position axis), so an imported model of it takes the
    dense fallback."""
    g = copy.deepcopy(graph)
    src, dst = g.idx("M1_prefix"), g.idx("M2_prefix")
    extra = g.add(StateDef("Ix_extra", {b: 0.25 for b in "ACGT"}))
    g.scale_out_edges(src, 0.99)
    g.set_edge(src, extra, 0.01)
    g.set_edge(extra, dst, 1.0)
    return g


def write_trained_hmms(workdir: str, db: str, read_length: int,
                       refused: bool = False) -> str:
    """A trained-HMM directory for ``Config.trained_hmms_dir``: for each
    locus of the DB, ``<vid>_<read_length>.json`` holding the read-matcher
    model that the engine itself builds for it at that read length (as
    ``refused_topology`` of it under ``refused``).  Returns the
    directory."""
    from advntr_tpu_torch.models.db import load_unique_vntrs_data
    from advntr_tpu_torch.models.hmm_json import save_trained_hmm
    out = os.path.join(workdir, "trained_hmms")
    os.makedirs(out, exist_ok=True)
    for ref in load_unique_vntrs_data(db):
        g = read_matcher(*model_key(ref, read_length, 0.05))
        save_trained_hmm(refused_topology(g) if refused else g,
                         os.path.join(out, f"{ref.id}_{read_length}.json"))
    return out


def simulate_cstb_reads(left: str, pattern: str, right: str,
                        read_length: int, n_reads: int, seed: int = 9):
    """``n_reads`` reads of ``read_length`` bp drawn uniformly from 2- and
    5-copy haplotypes, 0.3% substitutions."""
    rng = random.Random(seed)
    reads = []
    for _ in range(n_reads):
        copies = rng.choice([2, 5])
        hap = haplotype_sequence(left, pattern, copies, right)
        start = rng.randint(0, len(hap) - read_length)
        reads.append(mutate(hap[start:start + read_length], 0.003, rng))
    return reads


def write_cstb_sample(workdir: str, read_length: int = 100,
                      coverage: int = 40):
    """The CSTB 2/5 fixture of tests/test_cli_end_to_end.py: one-locus DB
    and an indexed BAM, half the reads mapped over the locus, half
    unmapped.  Returns (db path, bam path)."""
    left, right, start = rand_seq(1, 300), rand_seq(2, 300), 5000
    db = os.path.join(workdir, "models.db")
    ref = ReferenceVNTR(301645, CSTB_PATTERN, start, "chr21", "CSTB",
                        "Promoter", 3)
    ref.repeat_segments = [CSTB_PATTERN] * 3
    ref.left_flanking_region, ref.right_flanking_region = left, right
    create_vntrs_database(db)
    save_reference_vntr_to_database(ref, db)
    bam = os.path.join(workdir, "sample.bam")
    write_diploid_bam(bam, ref, 2, 5, read_length, coverage)
    return db, bam


def cstb_chromosome():
    """The CSTB locus of ``write_cstb_sample`` on a chromosome of its own:
    its 300-base flanks around its three units.  Returns (ReferenceVNTR,
    chromosome sequence), the inputs of a mutated-reference sweep."""
    left, right = rand_seq(1, 300), rand_seq(2, 300)
    ref = ReferenceVNTR(301645, CSTB_PATTERN, len(left), "chr21", "CSTB",
                        "Promoter", 3)
    ref.repeat_segments = [CSTB_PATTERN] * 3
    ref.left_flanking_region, ref.right_flanking_region = left, right
    return ref, left + CSTB_PATTERN * 3 + right


def write_diploid_bam(bam: str, ref, copies_a: int, copies_b: int,
                      read_length: int, coverage: float,
                      ref_length: int = 100000) -> None:
    """An indexed BAM of reads drawn from ``copies_a``- and
    ``copies_b``-copy haplotypes of a locus (its pattern between its
    flanks, 0.2% substitutions, seed 5): every other read mapped over the
    locus on its chromosome (``ref_length`` long), the others unmapped."""
    start = ref.start_point
    reads, _, _ = simulate_diploid_reads(
        ref.left_flanking_region, ref.pattern, copies_a, copies_b,
        ref.right_flanking_region, read_length=read_length,
        coverage=coverage, error_rate=0.002, seed=5)
    mapped, unmapped = [], []
    for i, (name, seq) in enumerate(reads):
        if i % 2 == 0:
            mapped.append(BamRead(
                query_name=name, flag=0, reference_id=0,
                reference_start=start - 50 + (i % 100), mapq=60,
                cigar=[(0, len(seq))], seq=seq, qual=[38] * len(seq)))
        else:
            unmapped.append(BamRead(
                query_name=name, flag=4, reference_id=-1,
                reference_start=-1, mapq=0, cigar=[], seq=seq,
                qual=[38] * len(seq)))
    mapped.sort(key=lambda r: r.reference_start)
    with BamWriter(bam, [ref.chromosome], [ref_length]) as w:
        for r in mapped + unmapped:
            w.write(r)
    build_bai(bam)


CSTB_DODECAMER = "CCCCGCCCCGCG"   # the dodecamer as the CSTB locus reads


def write_addmodel_reference(workdir: str, length: int = 2_000_000,
                             copies: int = 13, fragments: int = 12):
    """A seeded random chromosome ``chr21`` of ``length`` bases with the
    CSTB dodecamer x ``copies`` at its middle, and ``fragments`` mutated
    pieces of the repeat array (3 or 4 units, one or two substitutions)
    planted at seeded positions clear of the locus and its 500-base
    flanks: the decoys that ``addmodel``'s scan finds (about 500 windows
    a fragment, up to its cap of 10,000).  Writes ``reference.fa``;
    returns (fasta path, chromosome, start, end, pattern)."""
    from advntr_tpu_torch.io.fasta import write_fasta
    rng = random.Random(21)
    seq = [rng.choice("ACGT") for _ in range(length)]
    start = length // 2
    end = start + copies * len(CSTB_DODECAMER)
    seq[start:end] = CSTB_DODECAMER * copies
    placed = 0
    while placed < fragments:
        at = rng.randrange(1000, length - 1000)
        if abs(at - start) < 700 + end - start:
            continue
        frag = list(CSTB_DODECAMER * rng.choice([3, 4]))
        for _ in range(rng.choice([1, 2])):
            frag[rng.randrange(len(frag))] = rng.choice("ACGT")
        seq[at:at + len(frag)] = frag
        placed += 1
    fa = os.path.join(workdir, "reference.fa")
    write_fasta(fa, [("chr21", "".join(seq))])
    return fa, "chr21", start, end, CSTB_DODECAMER


FRAMESHIFT_VID, FRAMESHIFT_PATTERN = 25561, "ACGGTCAGT"
FRAMESHIFT_COPIES, FRAMESHIFT_START = 8, 3000


def frameshift_reads(read_length: int, frameshift: bool,
                     coverage: int = 30, seed: int = 2):
    """The reads of tests/test_frameshift_end_to_end.py: two haplotypes
    of 8 copies of ACGGTCAGT between 200-base flanks (seeds 5 and 6), the
    second with a 1-base deletion in copy 3 when ``frameshift``; 0.1%
    substitutions.  Returns [(name, sequence, offset in the haplotype)]."""
    left, right = rand_seq(5, 200), rand_seq(6, 200)
    p, copies = FRAMESHIFT_PATTERN, FRAMESHIFT_COPIES
    vntr_b = p * 3 + p[:4] + p[5:] + p * (copies - 4)
    haps = (left + p * copies + right,
            left + (vntr_b if frameshift else p * copies) + right)
    rng = random.Random(seed)
    reads = []
    for h, hap in enumerate(haps):
        for k in range(int(len(hap) * coverage / 2 / read_length)):
            start = rng.randint(0, len(hap) - read_length)
            reads.append((f"h{h}r{k}", mutate(
                hap[start:start + read_length], 0.001, rng), start))
    return reads


def write_frameshift_sample(workdir: str, read_length: int = 100,
                            frameshift: bool = True):
    """The frameshift fixture: a one-locus DB (VNTR 25561, one of the
    CLI's frameshift loci, at chr1:3000) and an indexed BAM of
    ``frameshift_reads`` at coverage 30, every other read mapped at its
    simulated position and the rest unmapped.  Returns (db path, bam
    path)."""
    db = os.path.join(workdir, "models.db")
    ref = ReferenceVNTR(FRAMESHIFT_VID, FRAMESHIFT_PATTERN,
                        FRAMESHIFT_START, "chr1",
                        estimated_repeats=FRAMESHIFT_COPIES)
    ref.repeat_segments = [FRAMESHIFT_PATTERN] * FRAMESHIFT_COPIES
    ref.left_flanking_region = rand_seq(5, 200)
    ref.right_flanking_region = rand_seq(6, 200)
    create_vntrs_database(db)
    save_reference_vntr_to_database(ref, db)
    mapped, unmapped = [], []
    for i, (name, seq, offset) in enumerate(
            frameshift_reads(read_length, frameshift)):
        if i % 2 == 0:
            mapped.append(BamRead(
                query_name=name, flag=0, reference_id=0,
                reference_start=FRAMESHIFT_START - 200 + offset, mapq=60,
                cigar=[(0, len(seq))], seq=seq, qual=[38] * len(seq)))
        else:
            unmapped.append(BamRead(
                query_name=name, flag=4, reference_id=-1,
                reference_start=-1, mapq=0, cigar=[], seq=seq,
                qual=[38] * len(seq)))
    mapped.sort(key=lambda r: r.reference_start)
    bam = os.path.join(workdir, "sample.bam")
    with BamWriter(bam, ["chr1"], [100000]) as w:
        for r in mapped + unmapped:
            w.write(r)
    build_bai(bam)
    return db, bam


def write_panel(workdir: str, n_loci: int = 16, read_length: int = 150,
                coverage: int = 30, seed: int = 0):
    """A multi-locus panel: ``n_loci`` loci whose motifs (6 bp and 12 bp)
    land in at least two model-shape buckets, with diploid unmapped reads
    at ``coverage``.  Returns (db path, bam path, {vid: (a, b)} truth)."""
    rng = random.Random(seed)
    db = os.path.join(workdir, "panel.db")
    create_vntrs_database(db)
    truth = {}
    all_reads = []
    for i in range(n_loci):
        vid = 1000 + i
        plen = (6, 12)[i % 2]
        pattern = "".join(rng.choice("ACGT") for _ in range(plen))
        ref = ReferenceVNTR(vid, pattern, 10000 + 5000 * i, "chr1")
        ref.repeat_segments = [pattern] * 3
        ref.left_flanking_region = rand_seq(seed * 1000 + 2 * i, 300)
        ref.right_flanking_region = rand_seq(seed * 1000 + 2 * i + 1, 300)
        save_reference_vntr_to_database(ref, db)
        a, b = sorted(rng.sample(range(2, 7), 2))
        truth[vid] = (a, b)
        reads, _, _ = simulate_diploid_reads(
            ref.left_flanking_region, pattern, a, b,
            ref.right_flanking_region, read_length=read_length,
            coverage=coverage, error_rate=0.002, seed=seed * 100 + i)
        all_reads += [(f"{vid}_{name}", seq) for name, seq in reads]
    bam = os.path.join(workdir, "panel.bam")
    with BamWriter(bam, ["chr1"], [200000]) as w:
        for name, seq in all_reads:
            w.write(BamRead(name, 4, -1, -1, 0, [], seq, [38] * len(seq)))
    return db, bam, truth


LONG_READ_MOTIF = "CGCGGGGCGGGGCACCCACGTACGT"   # 25 bases


def long_read_copies(L: int) -> int:
    """Copies of the long-read model for reads of L columns: the model
    grows with the window it must explain (a read that spans the tract
    leaves L - 600 bases of repeat), 60 up to L = 2,432."""
    return 60 if L <= 2432 else (L - 700) // len(LONG_READ_MOTIF)


def build_long_read_locus(L: int = 2432):
    """The long-read locus: a 25-base motif between 300-base flanks cut
    from two random 500-base flanks (seed 5), error rate 0.3,
    ``long_read_copies(L)`` copies.  Returns (graph, art, rng, hap): the
    generator stands where the reads are drawn from, and ``hap`` is the
    haplotype they are mutated from (8 copies short of the model, at
    least 40).  At L = 2,432 it has 4,262 states, and with the engine's
    padding (axes past 1,024 to multiples of 512) struct P 2,560."""
    rng = random.Random(5)
    left = "".join(rng.choice("ACGT") for _ in range(500))
    right = "".join(rng.choice("ACGT") for _ in range(500))
    copies = long_read_copies(L)
    trans, emis = profile_for_repeats([LONG_READ_MOTIF] * 3, 0.3)
    graph = build_read_matcher(left[-300:], right[:300], trans, emis, copies,
                               0.3)
    hap = left[-300:] + LONG_READ_MOTIF * max(40, copies - 8) + right[:300]
    return graph, compile_graph(graph), rng, hap


def simulate_long_reads(rng, hap: str, n_reads: int, L: int):
    """``n_reads`` reads of the haplotype, 8% substitutions, filled with
    random bases and cut to exactly L columns."""
    reads = []
    for _ in range(n_reads):
        s = mutate(hap, 0.08, rng)
        s = (s + "".join(rng.choice("ACGT")
                         for _ in range(max(0, L - len(s)))))[:L]
        reads.append(s)
    return reads


PACBIO_READ_LEN = 3000


def write_pacbio_panel(workdir: str, n_loci: int = 4, coverage: float = 10,
                       long_locus: int | None = 1, seed: int = 777):
    """A small long-read panel: ``n_loci`` loci with 500-base flanks and
    tracts up to about 1 kb, and (at index ``long_locus``) one long-tract
    locus of 2.3 to 2.9 kb whose read windows pass 2,048 columns; noisy
    3,000-base reads (1% substitutions, 4% insertions, 4% deletions, both
    orientations) in one FASTA file.  Returns (db path, fasta path,
    {vid: (a, b)} truth, [vid of the long-tract locus])."""
    rng = random.Random(seed)
    db = os.path.join(workdir, "pacbio_panel.db")
    create_vntrs_database(db)
    fa = os.path.join(workdir, "pacbio_reads.fa")
    truth, long_vids = {}, []
    with open(fa, "w") as fh:
        for i in range(n_loci):
            if i == long_locus:
                plen = rng.choice([20, 25, 30])
                ref_copies = max(3, rng.randint(2300, 2900) // plen)
                lo, hi = ref_copies - 3, ref_copies + 3
            else:
                plen = rng.choice([10, 15, 20, 25, 30, 40])
                hi = max(3, min(30, 1000 // plen))
                lo, ref_copies = 3, rng.randint(3, hi)
            pattern = "".join(rng.choice("ACGT") for _ in range(plen))
            ref = ReferenceVNTR(2000 + i, pattern, 10_000 * (i + 1), "chr1")
            ref.repeat_segments = [pattern] * ref_copies
            ref.left_flanking_region = "".join(
                rng.choice("ACGT") for _ in range(500))
            ref.right_flanking_region = "".join(
                rng.choice("ACGT") for _ in range(500))
            ref.estimated_repeats = ref_copies
            save_reference_vntr_to_database(ref, db)
            alleles = tuple(sorted((rng.randint(lo, hi),
                                    rng.randint(lo, hi))))
            truth[ref.id] = alleles
            if i == long_locus:
                long_vids.append(ref.id)
            # long-tract loci need reads that still span the tract and
            # both flank anchors
            read_len = max(PACBIO_READ_LEN, max(alleles) * plen + 1200)
            reads, _, _ = simulate_pacbio_reads(
                ref.left_flanking_region, pattern, alleles[0], alleles[1],
                ref.right_flanking_region, read_length=read_len,
                coverage=coverage, seed=900 + i)
            for name, seq in reads:
                fh.write(f">L{ref.id}_{name}\n{seq}\n")
    return db, fa, truth, long_vids


# ---- the randomized conformance soak (tests/test_conformance_soak.py) -----

def _rng_seq(rng, n: int) -> str:
    return "".join(rng.choice("ACGT") for _ in range(n))


SOAK_WIDTHS = {"plens": (5, 7, 11, 14), "flanks": (12, 20), "copies": (3, 5),
               "pos_bucket": 64}
# the soak widened to the cell's P 512 and the long-read model's P 2,560
SOAK_CELL = {"plens": (11, 12, 14), "flanks": (150,),
             "copies": (10, 11, 12, 13), "pos_bucket": 64}
SOAK_LONG = {"plens": (25,), "flanks": (300,),
             "copies": (60, 64, 68), "pos_bucket": 512}


def soak_model(rng, err: float, plens=SOAK_WIDTHS["plens"],
               flanks=SOAK_WIDTHS["flanks"], copies=SOAK_WIDTHS["copies"],
               pos_bucket: int = SOAK_WIDTHS["pos_bucket"]):
    """A random read-matcher model of the soak (make_model,
    tests/test_conformance_soak.py:23-43): a random motif of a length from
    ``plens``, three units that may each carry one substitution, random
    flanks of a length from ``flanks``, a copy count from ``copies``.  With
    the default widths the same ``random.Random`` draws give the
    reference's model.  Returns (graph, art, padded sm, left, pattern,
    right, copies); P pads to a multiple of ``pos_bucket`` above P and C
    to a multiple of 8."""
    plen = rng.choice(list(plens))
    pattern = _rng_seq(rng, plen)
    units = []
    for _ in range(3):
        u = list(pattern)
        if rng.random() < 0.5:
            u[rng.randrange(plen)] = rng.choice("ACGT")
        units.append("".join(u))
    left = _rng_seq(rng, rng.choice(list(flanks)))
    right = _rng_seq(rng, rng.choice(list(flanks)))
    n_copies = rng.choice(list(copies))
    trans, emis = profile_for_repeats(units, err)
    g = build_read_matcher(left, right, trans, emis, n_copies, err)
    art = compile_graph(g)
    sm = padded_structured(g, art, pos_bucket, 8)
    return g, art, sm, left, pattern, right, n_copies


def soak_read(rng, left: str, pattern: str, right: str, copies: int) -> str:
    """A read of the soak (make_read, tests/test_conformance_soak.py:
    46-68): a fragment, junk, a chimera or the whole haplotype, with up
    to four substitutions and indels."""
    hap = left + pattern * rng.randint(1, copies + 2) + right
    kind = rng.random()
    if kind < 0.5:
        a = rng.randint(0, max(0, len(hap) - 15))
        b = rng.randint(a + 10, len(hap))
        read = hap[a:b]
    elif kind < 0.7:
        read = _rng_seq(rng, rng.randint(10, 60))          # junk
    elif kind < 0.85:
        read = hap[: len(hap) // 2] + _rng_seq(rng, 20)    # chimera
    else:
        read = hap
    chars = list(read)
    for _ in range(rng.randint(0, 4)):
        op = rng.random()
        i = rng.randrange(len(chars))
        if op < 0.5:
            chars[i] = rng.choice("ACGT")
        elif op < 0.75 and len(chars) > 12:
            del chars[i]
        else:
            chars.insert(i, rng.choice("ACGT"))
    return "".join(chars)


def encode_reads(reads: list[str], pad_to: int):
    """(B, pad_to) int8 bases and (B,) int32 lengths, as the engine pads."""
    rows = [dna.encode(r) for r in reads]
    return dna.pad_batch(rows, pad_to=pad_to, multiple=32)


def rescore(art, path, codes) -> float:
    """f64 log-probability of an artifact-space path over a read."""
    s = float(art.log_start[path[0]] + art.log_E[path[0], codes[0]])
    for t in range(1, len(codes)):
        s += art.log_T[path[t - 1], path[t]] + art.log_E[path[t], codes[t]]
    return s + float(art.log_end[path[-1]])


def random_wide_model(P: int, C: int, seed: int, device, flank: int = 1100):
    """A TorchStructModel of P positions and C units with random float32
    tables and no host compile (the host's dense model of 20,000 positions
    would take 13 GB): a left flank of ``flank`` positions (block 0, the
    delete chain's longest run, so 2^r > flank rounds), C units of about
    equal length (blocks 1..C) and a suffix block of 100 positions
    (C + 1), nb = C + 2, as the engine's models are laid out.  Log
    weights are drawn from (-6, -0.05), a tenth of the transitions into
    and inside a position set to NEG, and every model table the forward
    kernel reads follows from those as ``TorchStructModel.from_payload``
    derives it; the walk's state tables are left zero.  For holding B1's
    wide entry to its twin on shapes no real model of the tests reaches."""
    import numpy as np
    import torch

    from advntr_tpu_torch.ops.struct_model import (BLK_ROWS, NEG, POS,
                                                   POS_ROWS,
                                                   TorchStructModel,
                                                   delete_windows,
                                                   unit_windows)
    rng = np.random.default_rng(seed)
    nb = C + 2
    suffix = 100
    assert flank + C + suffix <= P, "too many units for the positions"
    blk_idx = np.full(P, C + 1, dtype=np.int64)
    blk_idx[:flank] = 0
    bounds = np.linspace(flank, P - suffix, C + 1).round().astype(np.int64)
    for c in range(C):
        blk_idx[bounds[c]:bounds[c + 1]] = c + 1
    unit_last = bounds[1:] - 1
    draw = lambda *shape: rng.uniform(-6, -0.05, shape)
    pos = draw(len(POS_ROWS), P)
    pos[:POS["xm"]][rng.random((POS["xm"], P)) < 0.1] = NEG
    last = np.zeros(P, dtype=bool)
    last[unit_last] = True
    last[P - 1] = True
    for name in ("xm", "xi", "xd"):
        pos[POS[name], ~last] = NEG
    pos[POS["le_M"]][rng.random(P) < 0.5] = NEG
    pos[POS["le_I"]][rng.random(P) < 0.5] = NEG
    dd = draw(P)
    dd[np.flatnonzero(np.diff(blk_idx, prepend=-1))] = NEG
    r_unit = float(np.float32(rng.uniform(-3, -0.5)))
    f32 = lambda x: torch.as_tensor(np.asarray(x, dtype=np.float32),
                                    device=device)
    i32 = lambda x: torch.as_tensor(np.asarray(x, dtype=np.int32),
                                    device=device)
    zeros = np.zeros(2 * P + nb, dtype=np.int64)
    return TorchStructModel(
        P=P, nb=nb, C=C, suffix_last=P - 1, r_unit=r_unit, pos=f32(pos),
        blk=f32(draw(len(BLK_ROWS), nb)), eM=f32(draw(P, 4)),
        eI=f32(draw(P, 4)), eI0=f32(draw(nb, 4)), Wd=f32(delete_windows(dd)),
        Wu=f32(unit_windows(r_unit, C)), blk_idx=i32(blk_idx),
        exp_base=i32(rng.integers(0, 4, P)), unit_last=i32(unit_last),
        region=i32(zeros), unit=i32(zeros),
        struct_to_art=torch.as_tensor(zeros, device=device),
        art_meta=tuple(i32(np.zeros(1)) for _ in range(4)))
