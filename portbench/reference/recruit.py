"""adVNTR's keyword recruitment of unmapped reads, in NumPy.

Each locus has a set of 15-base keywords: for short reads, every fifth
15-mer (sixth for a 5-base motif) of the tract with 15 bases of each
flank; for long reads, every second 15-mer of the 80 bases of each flank
next to the tract and of their reverse complements.  A read's count for a
locus is the number of its positions whose 15-mer is one of the locus's
keywords.  A read goes to each of its 16 best loci (higher count first,
then the locus listed first) where its count reaches the minimum (5 for
short reads, 3 for long ones); a locus keeps its 2,000 best reads (count,
then name, descending).
"""

from __future__ import annotations

import numpy as np

K = 15
TOP_LOCI = 16
MAX_READS = 2000


def keywords(locus: dict, short_reads: bool) -> set[str]:
    if short_reads:
        tract = "".join(locus["segments"])
        if len(tract) < K:
            tract = tract * (K // len(tract) + 1)
        seq = locus["left"][-15:] + tract + locus["right"][:15]
        step = 6 if len(locus["pattern"]) == 5 else 5
        return {seq[i:i + K] for i in range(0, len(seq) - K + 1, step)}
    comp = str.maketrans("ACGT", "TGCA")
    probes = [locus["left"][-80:], locus["right"][:80]]
    probes += [p.translate(comp)[::-1] for p in probes]
    return {p[i:i + K] for p in probes
            for i in range(0, max(1, len(p) - K + 1), 2)}


def _kmer_codes(seqs: list[str]):
    """(code of every read position's 15-mer, its read index); positions
    whose 15-mer leaves the read or holds a base other than ACGT are
    dropped.  A code fits 30 bits."""
    table = np.full(256, 4, dtype=np.int32)
    for i, b in enumerate(b"ACGT"):
        table[b] = i
    joined = np.frombuffer(("|".join(seqs) + "|").encode(), dtype=np.uint8)
    base = table[joined]
    n = base.size - K + 1
    bad = np.concatenate([[0], np.cumsum(base >= 4)])
    bad = bad[K:K + n] - bad[:n] > 0
    base = np.where(base < 4, base, 0)
    code = np.zeros(n, dtype=np.int32)
    for j in range(K):
        code <<= 2
        code |= base[j:j + n]
    read_of = np.repeat(np.arange(len(seqs)), [len(s) + 1 for s in seqs])
    keep = ~bad
    return code[keep], read_of[:n][keep]


def recruit(loci: list[dict], reads: list, short_reads: bool) -> dict:
    """{vid: [read name, ...]} in the order a locus ranks its reads."""
    vids = sorted(lc["vid"] for lc in loci)
    by_vid = {lc["vid"]: lc for lc in loci}
    entries = []
    for li, vid in enumerate(vids):
        for kw in keywords(by_vid[vid], short_reads):
            if set(kw) <= set("ACGT"):
                c = 0
                for ch in kw:
                    c = c * 4 + "ACGT".index(ch)
                entries.append((c, li))
    entries.sort()
    t_code = np.array([e[0] for e in entries], dtype=np.int64)
    t_locus = np.array([e[1] for e in entries], dtype=np.int64)
    prefix = np.zeros(1 << 20, dtype=bool)
    prefix[t_code >> 10] = True
    min_matches = 5 if short_reads else 3
    names = [r[0] for r in reads]
    pairs = []
    for b0 in range(0, len(reads), 20_000):     # in blocks: memory
        code, read_of = _kmer_codes([r[1].upper()
                                     for r in reads[b0:b0 + 20_000]])
        near = np.nonzero(prefix[code >> 10])[0]   # a keyword's first 10
        code, read_of = code[near], read_of[near]
        lo = np.searchsorted(t_code, code, "left")
        hi = np.searchsorted(t_code, code, "right")
        hit = hi > lo
        code_hits = np.repeat(np.nonzero(hit)[0], (hi - lo)[hit])
        starts = np.repeat(lo[hit], (hi - lo)[hit])
        offs = np.arange(code_hits.size) - np.repeat(
            np.cumsum((hi - lo)[hit]) - (hi - lo)[hit], (hi - lo)[hit])
        pairs.append((read_of[code_hits] + b0) * len(vids) +
                     t_locus[starts + offs])
    uniq, count = np.unique(np.concatenate(pairs) if pairs else
                            np.zeros(0, np.int64), return_counts=True)
    per_read: dict[int, list] = {}
    for p, c in zip(uniq.tolist(), count.tolist()):
        per_read.setdefault(p // len(vids), []).append((-c, p % len(vids)))
    buckets: dict[int, list] = {vid: [] for vid in vids}
    for r, cands in per_read.items():
        for neg, li in sorted(cands)[:TOP_LOCI]:
            if -neg >= min_matches:
                buckets[vids[li]].append((-neg, names[r]))
    return {vid: [n for _, n in sorted(b, reverse=True)[:MAX_READS]]
            for vid, b in buckets.items()}
