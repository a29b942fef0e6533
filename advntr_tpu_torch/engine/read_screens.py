"""Alternative lightweight read screens (offline analysis).

Capability-equivalent to the reference advntr/acgt_filter.py: candidate-read
selection by nucleotide-composition sliding windows or by motif k-mer
presence — cheap pre-filters used in recruitment-method comparisons.
Vectorized with numpy (the composition scan is a cumulative-count rolling
window).
"""

from __future__ import annotations

import numpy as np

from advntr_tpu_torch import dna


def nucleotide_map(sequence: str) -> np.ndarray:
    codes = dna.encode(sequence)
    return np.bincount(codes[codes < 4], minlength=4)


def composition_window_match(query: str, read: str,
                             max_dist: int = 3) -> int:
    """1 if some |query|-length window of the read matches the query's base
    composition within max_dist (L1), 2 for the reverse complement, else 0."""
    q = nucleotide_map(query)
    rq = nucleotide_map(dna.revcomp(query))
    codes = dna.encode(read)
    k = len(query)
    n = len(read)
    onehot = np.zeros((n, 4), dtype=np.int32)
    valid = codes < 4
    onehot[np.arange(n)[valid], codes[valid]] = 1
    cum = np.cumsum(onehot, axis=0)
    # rolling composition for every window ending at i (window may be
    # truncated at the start, matching the reference's incremental counter)
    for i in range(n):
        start = i - k + 1
        window = cum[i] - (cum[start - 1] if start > 0 else 0)
        if np.abs(q - window).sum() < max_dist:
            return 1
        if np.abs(rq - window).sum() < max_dist:
            return 2
    return 0


def composition_screen(query: str, reads) -> list[tuple[int, str]]:
    """(index, sequence) of reads passing the composition window screen."""
    out = []
    for i, seq in enumerate(reads):
        if composition_window_match(query, seq) > 0:
            out.append((i, seq))
    return out


def rotation_kmers(query: str, k: int) -> list[str]:
    """All k-mers of the doubled motif (covers cyclic rotations)."""
    doubled = query + query
    return [doubled[i:i + k] for i in range(len(doubled) - k + 1)]


def kmer_screen(query: str, k: int, reads) -> list[tuple[int, str]]:
    """(index, sequence) of reads containing any rotation k-mer."""
    kmers = rotation_kmers(query, k)
    out = []
    for i, seq in enumerate(reads):
        if any(km in seq for km in kmers):
            out.append((i, seq))
    return out
