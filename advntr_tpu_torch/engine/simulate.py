"""Read simulators: model-training decoys and end-to-end test harnesses.

Mirrors the reference's verification machinery (there are no recorded BAM
fixtures upstream either; simulation *is* the test harness —
vntr_finder.py:924-1003, reference_editor.py):

- simulate_true_reads: sliding windows over the locus +-flank, with 1-2
  random SNPs each, plus boundary-straddling and pure-repeat special reads
- simulate_diploid_reads: uniform read sampling from two haplotypes with a
  per-base error rate, for end-to-end genotyping tests
"""

from __future__ import annotations

import random

ALPHABET = "ACGT"


def simulate_true_reads(ref_vntr, read_length: int,
                        rng: random.Random | None = None) -> list[str]:
    """Recruitment-positive read set for threshold training
    (reference semantics: vntr_finder.py:973-1003)."""
    rng = rng or random.Random(0)
    vntr = "".join(ref_vntr.get_repeat_segments())
    right_flank = ref_vntr.right_flanking_region
    left_flank = ref_vntr.left_flanking_region
    locus = left_flank[-read_length:] + vntr + right_flank[:read_length]
    sim_reads = []
    for i in range(0, len(locus) - read_length + 1):
        sim_reads.append(locus[i:i + read_length].upper())
    for copies in range(1, len(ref_vntr.get_repeat_segments()) - 1):
        vntr_section = "".join(ref_vntr.get_repeat_segments()[:copies])
        for i in range(1, 11):
            sim_reads.append((left_flank[-i:] + vntr_section + right_flank)[:read_length])
            sim_reads.append((left_flank + vntr_section + right_flank[:i])[-read_length:])
    min_copies = len(vntr) and (read_length // len(vntr) + 1)
    for i in range(1, 21):
        sim_reads.append((vntr * min_copies)[i:read_length + i])
        sim_reads.append((vntr * min_copies)[-read_length - i:-i])
    out = []
    for sim_read in sim_reads:
        for _ in range(rng.randint(1, 2)):
            chars = list(sim_read)
            chars[rng.randint(0, len(sim_read) - 1)] = \
                ALPHABET[rng.randint(0, 3)]
            sim_read = "".join(chars)
        out.append(sim_read)
    return out


def haplotype_sequence(left_flank: str, pattern: str, copies: int,
                       right_flank: str) -> str:
    return left_flank + pattern * copies + right_flank


def mutate(seq: str, error_rate: float, rng: random.Random) -> str:
    if error_rate <= 0:
        return seq
    chars = list(seq)
    for i in range(len(chars)):
        if rng.random() < error_rate:
            chars[i] = ALPHABET[rng.randint(0, 3)]
    return "".join(chars)


def simulate_diploid_reads(left_flank: str, pattern: str,
                           copies_a: int, copies_b: int, right_flank: str,
                           read_length: int = 150, coverage: float = 20,
                           error_rate: float = 0.005, seed: int = 0):
    """Sample reads uniformly over two haplotypes at the given coverage.

    Returns (reads, n_a, n_b): list of (name, sequence).
    """
    rng = random.Random(seed)
    reads = []
    counts = [0, 0]
    for h, copies in enumerate((copies_a, copies_b)):
        hap = haplotype_sequence(left_flank, pattern, copies, right_flank)
        n_reads = int(len(hap) * coverage / 2 / read_length)
        for k in range(n_reads):
            start = rng.randint(0, len(hap) - read_length)
            seq = mutate(hap[start:start + read_length], error_rate, rng)
            reads.append((f"hap{h}_read{k}", seq))
            counts[h] += 1
    rng.shuffle(reads)
    return reads, counts[0], counts[1]


def mutate_with_indels(seq: str, sub_rate: float, ins_rate: float,
                       del_rate: float, rng: random.Random) -> str:
    """Long-read error model: per-base substitution / insertion / deletion
    (PacBio CLR-style noise; the reference models it with
    MAX_ERROR_RATE=0.3 on the HMM side, advntr_commands.py:66-71)."""
    out = []
    for ch in seq:
        r = rng.random()
        if r < del_rate:
            continue
        if r < del_rate + ins_rate:
            out.append(ch)
            out.append(ALPHABET[rng.randint(0, 3)])
            continue
        if r < del_rate + ins_rate + sub_rate:
            out.append(ALPHABET[rng.randint(0, 3)])
            continue
        out.append(ch)
    return "".join(out)


def simulate_pacbio_reads(left_flank: str, pattern: str,
                          copies_a: int, copies_b: int, right_flank: str,
                          read_length: int = 3000, coverage: float = 10,
                          sub_rate: float = 0.01, ins_rate: float = 0.04,
                          del_rate: float = 0.04, seed: int = 0):
    """Sample multi-kb noisy reads over two haplotypes.

    Each haplotype contributes coverage/2 read depth; read windows are
    uniform over the haplotype, so reads spanning the VNTR (what the
    PacBio pipeline consumes after flank anchoring) appear at the natural
    rate.  Returns (reads, n_a, n_b) with reads = [(name, sequence)].
    """
    rng = random.Random(seed)
    reads = []
    counts = [0, 0]
    for h, copies in enumerate((copies_a, copies_b)):
        hap = haplotype_sequence(left_flank, pattern, copies, right_flank)
        span = max(len(hap), read_length)
        n_reads = max(1, int(round(span * coverage / 2 / read_length)))
        for k in range(n_reads):
            start = rng.randint(-(read_length - 1), len(hap) - 1)
            window = hap[max(0, start):start + read_length]
            seq = mutate_with_indels(window, sub_rate, ins_rate, del_rate,
                                     rng)
            if len(seq) < 30:
                continue
            if rng.random() < 0.5:
                from advntr_tpu_torch import dna
                seq = dna.revcomp(seq)
            reads.append((f"hap{h}_lr{k}", seq))
            counts[h] += 1
    rng.shuffle(reads)
    return reads, counts[0], counts[1]
