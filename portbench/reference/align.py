"""Local alignment of a 100-base flank probe inside long reads (match +1,
mismatch -1, gap -1, linear), and adVNTR's spanning windows, in plain
PyTorch.

For a read and a probe: the best score over all cells, the end of the
alignment (the first read position at which a row reaches that score,
exclusive), and its start, found as ``length - end`` of the same
alignment over the reversed read and probe.  The columns of the dynamic
program are the probe's positions: within a column the read axis carries
``H[t] = max(X_t, H[t-1] - 1)``, a running maximum of ``X_t + t``, so a
column is a few tensor operations over all reads at once.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.genotype import encode, revcomp

FLANK = 100


def best_and_end(reads: list[np.ndarray], probe: np.ndarray, device):
    """(best score, end) of ``probe`` in each read."""
    B, L = len(reads), max(len(r) for r in reads)
    x = torch.full((B, L), 9, dtype=torch.int64, device=device)
    for b, r in enumerate(reads):
        x[b, :len(r)] = torch.as_tensor(r.astype(np.int64))
    t = torch.arange(L, device=device)[None, :]
    prev = torch.zeros((B, L), dtype=torch.int64, device=device)
    row_best = torch.zeros((B, L), dtype=torch.int64, device=device)
    for j in range(len(probe)):
        sub = torch.where(x == int(probe[j]), 1, -1)
        diag = torch.cat([torch.zeros((B, 1), dtype=torch.int64,
                                      device=device), prev[:, :-1]], 1) + sub
        X = torch.maximum(torch.maximum(diag, prev - 1),
                          torch.zeros_like(prev))
        col = torch.cummax(X + t, dim=1).values - t
        row_best = torch.maximum(row_best, col)
        prev = col
    row_best = torch.where(x == 9, -1, row_best)
    best = row_best.max(dim=1).values
    first = torch.where(row_best == best[:, None], t, L).min(dim=1).values
    best, first = best.cpu().numpy(), first.cpu().numpy()
    return best, np.where(best > 0, first + 1, 0)


def spanning_windows(reads: list, left: str, right: str, error_rate: float,
                     device) -> list:
    """[(name, window)]: each orientation of each read in which both flank
    probes align with at least ``(1 - error) * 100``, the left one first;
    the window runs from the left probe's start to 100 bases past the
    right probe's start."""
    left, right = left[-FLANK:], right[:FLANK]
    names, seqs = [], []
    for name, seq in reads:
        seq = seq.upper()
        for s in (seq, revcomp(seq)):
            names.append(name)
            seqs.append(s)
    if not seqs:
        return []
    fwd = [encode(s) for s in seqs]
    rev = [c[::-1].copy() for c in fwd]
    out = {}
    for key, probe in (("l", encode(left)), ("r", encode(right))):
        score, end = best_and_end(fwd, probe, device)
        _, rend = best_and_end(rev, probe[::-1].copy(), device)
        lens = np.array([len(s) for s in seqs])
        out[key] = (score, lens - rend)
    need = len(left) * (1 - error_rate), len(right) * (1 - error_rate)
    windows = []
    for i, s in enumerate(seqs):
        if out["l"][0][i] < need[0] or out["r"][0][i] < need[1]:
            continue
        sl, sr = int(out["l"][1][i]), int(out["r"][1][i])
        if sr < sl:
            continue
        windows.append((names[i], s[sl:sr + FLANK]))
    return windows
