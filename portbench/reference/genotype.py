"""adVNTR's read statistics, read gates and diploid genotype, in plain
Python and NumPy (``hmm_utils.py`` path analytics, ``vntr_finder.py``
recruit and spanning gates, ``find_genotype``)."""

from __future__ import annotations

import numpy as np

from portbench.reference.hmm import MATCH, PREFIX, REPEAT, SUFFIX

MIN_BP_IN_REPEAT = 3
ERROR_RATE_GENOTYPE = 0.03
COMP = str.maketrans("ACGT", "TGCA")


def revcomp(seq: str) -> str:
    return seq.translate(COMP)[::-1]


def encode(seq: str) -> np.ndarray:
    table = np.full(256, 4, dtype=np.int8)
    for i, b in enumerate(b"ACGT"):
        table[b] = i
    return table[np.frombuffer(seq.encode(), dtype=np.uint8)]


def path_stats(meta: dict, path: np.ndarray, codes: np.ndarray) -> dict:
    """The statistics of one decoded path (visited state positions from
    start to end): repeat units by unit boundaries crossed with at least
    three bases on the far side, bases in each region, matches, and flank
    matches (a flank match state that read its flank's base)."""
    emit = meta["emitting"][path]
    bp = np.cumsum(emit)                     # bases read so far, inclusive
    n = len(codes)
    us = meta["unit_start"][path] & (n - bp >= MIN_BP_IN_REPEAT)
    ue = meta["unit_end"][path] & (bp >= MIN_BP_IN_REPEAT)
    delta = 0
    if us.any() and ue.any():
        fs, ls = bp[us][0], bp[us][-1]
        fe, le = bp[ue][0], bp[ue][-1]
        delta = int(fe < fs and ls > le)
    region, kind = meta["region"][path], meta["kind"][path]
    read_base = np.where(emit, codes[np.clip(bp - 1, 0, n - 1)], -9)
    hit = emit & (kind == MATCH) & (meta["consensus"][path] == read_base)
    return {
        "repeats": max(int(us.sum()), int(ue.sum())) + delta,
        "n_matches": int((emit & (kind == MATCH)).sum()),
        "repeat_bp": int((emit & (region == REPEAT)).sum()),
        "left_flank_bp": int((emit & (region == SUFFIX)).sum()),
        "right_flank_bp": int((emit & (region == PREFIX)).sum()),
        "left_flank_matches": int((hit & (region == SUFFIX)).sum()),
        "right_flank_matches": int((hit & (region == PREFIX)).sum()),
    }


def flank_rate(s: dict) -> float:
    left = s["left_flank_matches"] / s["left_flank_bp"] \
        if s["left_flank_bp"] else 1.0
    right = s["right_flank_matches"] / s["right_flank_bp"] \
        if s["right_flank_bp"] else 1.0
    return min(left, right)


def homology_runs(pattern: str, left: str, right: str) -> tuple[int, int]:
    """The longest run of each flank, next to the tract, that continues
    some rotation of the motif (the spanning gate's minimum flank)."""
    def run(flank: str, motif: str) -> int:
        best = 0
        p = len(motif)
        for r in range(p):
            k = 0
            while k < len(flank) and flank[k] == motif[(r + k) % p]:
                k += 1
            best = max(best, k)
        return best
    return run(left[::-1], pattern[::-1]), run(right, pattern)


def find_genotype(observed: list[int], r: float = ERROR_RATE_GENOTYPE):
    """The maximum-likelihood diploid pair over observed unit counts and
    its posterior (adVNTR's conditional likelihood with r = 0.03)."""
    counts: dict[int, int] = {}
    for cn in observed:
        counts[cn] = counts.get(cn, 0) + 1
    if len(counts) < 2:
        prior = 0.5
        counts[0] = 1
    else:
        k = len(counts)
        prior = 1.0 / (k * (k - 1) / 2)
    items = sorted(counts.items(), key=lambda kv: kv[1], reverse=True)
    r_e = r / (2 + r)

    def cond(ck, ci, cj):
        if ck == ci == cj:
            return 1 - r
        if cj == 0:
            return 0.5 * (1 - r)
        if ck == ci:
            return 0.5 * ((1 - r) + r_e ** abs(ck - cj))
        if ck == cj:
            return 0.5 * ((1 - r) + r_e ** abs(ck - ci))
        return 0.5 * (r_e ** abs(ck - ci) + r_e ** abs(ck - cj))

    terms: dict = {}
    for ck, occ in items:
        if ck == 0:
            continue
        for i in range(len(items)):
            for j in range(i, len(items)):
                key = (items[i][0], items[j][0])
                terms.setdefault(key, []).append(
                    cond(ck, key[0], key[1]) ** occ)
    post = {key: float(np.prod(np.array(v))) * prior
            for key, v in terms.items()}
    total = sum(post.values())
    best, best_p = None, 1e-20
    for key, value in post.items():
        if total and value / total > best_p:
            best, best_p = key, value / total
    return best, best_p


def call_text(pair) -> str:
    return "None" if pair is None else "/".join(str(c) for c in sorted(pair))


def short_read_call(reads: list, rows: list, stats: list, logp: np.ndarray,
                    min_flanks: tuple[int, int]) -> tuple[str, list]:
    """The call of one Illumina locus from its scored rows (both
    orientations of each unmapped read, forward first), and each read's
    verdict (name, selected, spanning, repeats)."""
    best: dict[int, int] = {}
    for k, (ri, _) in enumerate(rows):
        if ri not in best or logp[k] > logp[best[ri]]:
            best[ri] = k
    covered, flanking, verdicts = [], [], []
    for ri in sorted(best):
        k = best[ri]
        s, lp, n = stats[k], logp[k], len(reads[ri][1])
        rate = flank_rate(s)
        recruited = rate >= 0.90 and s["n_matches"] >= 0.9 * n and lp > -n
        selected = bool(np.isfinite(lp) and recruited and
                        s["repeat_bp"] > 2)
        spanning = selected and rate >= 0.95 and \
            s["left_flank_bp"] > min_flanks[0] and \
            s["right_flank_bp"] > min_flanks[1]
        if spanning:
            covered.append(s["repeats"])
        elif selected:
            flanking.append(s["repeats"])
        verdicts.append((reads[ri][0], selected, spanning,
                         s["repeats"] if selected else -1))
    flanking.sort()
    top = []
    if flanking:
        floor = max(covered) if covered else 0
        top = [r for r in flanking if r == flanking[-1] and r >= floor]
        if len(top) < 5:
            top = []
    return call_text(find_genotype(covered + top)[0]), verdicts


def long_read_call(repeats: list[int], logp: np.ndarray) -> str:
    observed = [r for r, lp in zip(repeats, logp) if np.isfinite(lp)]
    if not repeats:
        return "None"
    return call_text(find_genotype(observed)[0])
