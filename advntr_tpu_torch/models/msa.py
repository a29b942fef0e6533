"""Internal multiple sequence alignment (no external MUSCLE binary).

The reference calls MUSCLE for three jobs: repeat-unit profile estimation
(profile_hmm.py:165-171), PacBio haplotype clustering/consensus
(pacbio_haplotyper.py:40,75), and the --update MSA-of-Viterbi-paths path is
already MUSCLE-free (hmm_utils.py:23-67).  Repeat units at one locus are
highly similar, so a center-star MSA built from pairwise Needleman-Wunsch
alignments is an adequate stand-in; it also keeps the framework free of
subprocess boundaries.

Also implements the Viterbi-path-based MSA used by model updating, operating
on reference-style state-name paths (semantics of hmm_utils.py:23-103).
"""

from __future__ import annotations

import numpy as np

_MATCH = 1
_MISMATCH = -1
_GAP = -1


def needleman_wunsch(a: str, b: str) -> tuple[str, str, int]:
    """Global alignment with unit match/mismatch/gap scores; returns aligned
    strings (with '-') and the score."""
    n, m = len(a), len(b)
    av = np.frombuffer(a.encode(), dtype=np.uint8)
    bv = np.frombuffer(b.encode(), dtype=np.uint8)
    score = np.zeros((n + 1, m + 1), dtype=np.int32)
    ptr = np.zeros((n + 1, m + 1), dtype=np.int8)  # 0=diag 1=up(a gap in b) 2=left
    score[:, 0] = np.arange(n + 1) * _GAP
    score[0, :] = np.arange(m + 1) * _GAP
    ptr[1:, 0] = 1
    ptr[0, 1:] = 2
    for i in range(1, n + 1):
        sub = np.where(bv == av[i - 1], _MATCH, _MISMATCH)
        row_prev = score[i - 1]
        row = score[i]
        # vectorized over j is impossible for the left-dependency; do a fast
        # scalar loop (segments are short: <= a few hundred bp)
        for j in range(1, m + 1):
            d = row_prev[j - 1] + sub[j - 1]
            u = row_prev[j] + _GAP
            l = row[j - 1] + _GAP
            best = d
            p = 0
            if u > best:
                best, p = u, 1
            if l > best:
                best, p = l, 2
            row[j] = best
            ptr[i, j] = p
    # traceback
    ai, bi = [], []
    i, j = n, m
    while i > 0 or j > 0:
        p = ptr[i, j]
        if i > 0 and j > 0 and p == 0:
            ai.append(a[i - 1]); bi.append(b[j - 1]); i -= 1; j -= 1
        elif i > 0 and (p == 1 or j == 0):
            ai.append(a[i - 1]); bi.append("-"); i -= 1
        else:
            ai.append("-"); bi.append(b[j - 1]); j -= 1
    return "".join(reversed(ai)), "".join(reversed(bi)), int(score[n, m])


def _merge_into_star(center_cols: list[str], rows: list[list[str]],
                     aligned_center: str, aligned_other: str):
    """Merge one pairwise (center, other) alignment into the growing MSA using
    'once a gap, always a gap' on the center sequence.

    center_cols: the center sequence as currently laid out in MSA columns
    (may contain '-'); rows: previously merged sequences in the same columns.
    Returns the new (center_cols, rows) with the new sequence appended.
    """
    new_row: list[str] = []
    out_center: list[str] = []
    out_rows: list[list[str]] = [[] for _ in rows]
    msa_i = 0   # index into center_cols
    pair_i = 0  # index into aligned_center

    while msa_i < len(center_cols) or pair_i < len(aligned_center):
        msa_gap = msa_i < len(center_cols) and center_cols[msa_i] == "-"
        pair_gap = pair_i < len(aligned_center) and aligned_center[pair_i] == "-"
        if msa_gap or pair_i >= len(aligned_center):
            # existing MSA gap column the new pair doesn't know about
            out_center.append("-")
            for r, row in enumerate(rows):
                out_rows[r].append(row[msa_i])
            new_row.append("-")
            msa_i += 1
        elif pair_gap or msa_i >= len(center_cols):
            # new pairwise alignment inserts a fresh gap column into the center
            out_center.append("-")
            for r in range(len(rows)):
                out_rows[r].append("-")
            new_row.append(aligned_other[pair_i])
            pair_i += 1
        else:
            # both sides hold the same real center character
            out_center.append(center_cols[msa_i])
            for r, row in enumerate(rows):
                out_rows[r].append(row[msa_i])
            new_row.append(aligned_other[pair_i])
            msa_i += 1
            pair_i += 1
    out_rows.append(new_row)
    return out_center, out_rows


def center_star_msa(seqs: list[str]) -> list[str]:
    """Center-star MSA: pick the sequence with the best total pairwise score
    as the center, align everyone to it, merge with once-a-gap-always-a-gap.

    Row order matches input order (the profile estimator is row-order
    independent anyway).
    """
    if len(seqs) == 1:
        return list(seqs)
    n = len(seqs)
    if n == 2:
        a, b, _ = needleman_wunsch(seqs[0], seqs[1])
        return [a, b]
    # choose center: maximize the sum of pairwise alignment scores
    totals = np.zeros(n)
    pair_cache: dict[tuple[int, int], tuple[str, str, int]] = {}
    for i in range(n):
        for j in range(i + 1, n):
            _, _, s = pair_cache.setdefault(
                (i, j), needleman_wunsch(seqs[i], seqs[j]))
            totals[i] += s
            totals[j] += s
    center = int(np.argmax(totals))

    center_cols = list(seqs[center])
    rows: list[list[str]] = []
    order = [center] + [i for i in range(n) if i != center]
    for idx in order[1:]:
        i, j = min(center, idx), max(center, idx)
        ac, ao, _ = pair_cache[(i, j)]
        if i != center:  # cached alignment is (seqs[i], seqs[j]) = (other, center)
            ac, ao = ao, ac
        center_cols, rows = _merge_into_star(center_cols, rows, ac, ao)

    # restore input order
    aligned = ["" for _ in range(n)]
    aligned[center] = "".join(center_cols)
    for k, idx in enumerate(order[1:]):
        aligned[idx] = "".join(rows[k])
    return aligned


# ---------------------------------------------------------------------------
# Viterbi-path based MSA (reference semantics: hmm_utils.py:23-103)
# ---------------------------------------------------------------------------

def msa_from_viterbi_paths(repeat_sequences: list[str],
                           repeat_state_paths: list[list[str]]) -> list[str]:
    """Build an MSA from per-repeat Viterbi state paths.

    Each path is a list of in-unit state names like ['M1_2','I1_2','M2_2',...].
    Columns are derived from the max multiplicity of each M{i}/I{i} label over
    all paths, in (M0,I0,M1,I1,...) order; each sequence is threaded through
    the column list, consuming one character wherever its own path contains
    the column label (multiplicity-aware), else emitting '-'.
    """
    alignment_states: dict[str, int] = {}
    max_index = 0
    for path in repeat_state_paths:
        state_counts: dict[str, int] = {}
        for state in path:
            base = state.split("_")[0]
            state_counts[base] = state_counts.get(base, 0) + 1
        for key, value in state_counts.items():
            idx = int(key[1:])
            max_index = max(max_index, idx)
            alignment_states[key] = max(alignment_states.get(key, 0), value)

    columns: list[str] = []
    for i in range(max_index + 1):
        for prefix in ("M", "I"):
            key = f"{prefix}{i}"
            if key in alignment_states:
                columns.extend([key] * alignment_states[key])

    aligned: list[str] = []
    for seq, path in zip(repeat_sequences, repeat_state_paths):
        bases = [s.split("_")[0] for s in path]
        row = []
        seq_index = 0
        for col in columns:
            found = False
            for k, b in enumerate(bases):
                if b == col:
                    bases[k] = None
                    found = True
            if found:
                row.append(seq[seq_index])
                seq_index += 1
            else:
                row.append("-")
        aligned.append("".join(row))
    return aligned
