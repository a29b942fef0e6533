"""Pairwise local alignment (Smith-Waterman) for flank anchoring.

Replaces Bio.pairwise2.align.localms(read, flank, 1, -1, -1, -1)
(reference: vntr_finder.py:324-365) for PacBio spanning-read extraction:
find where a 100bp flank best aligns inside a long read.

Host implementation is numpy, vectorized over the flank axis (the flank is
short; the read provides the long loop).  Scores: match +1, mismatch -1,
gap open/extend -1 (linear gaps, matching the reference's localms call).

Counterpart of advntr_tpu/ops/align.py: ``local_align`` and
``global_align_score`` are the reference's, copied; ``local_align_batch``
is its scan over read columns as a hand-written CUDA kernel
(csrc/local_align.cu) for CUDA tensors and as plain PyTorch
(``local_align_batch_reference``) for CPU ones.  All of it is int32
arithmetic, so the three agree exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from advntr_tpu_torch import dna
from advntr_tpu_torch.ops import _kernels


def local_align(read: str, probe: str):
    """Best local alignment of probe inside read.

    Returns (score, read_start, read_end): read coordinates of the aligned
    window (end exclusive).  Score semantics match localms(1,-1,-1,-1).
    """
    n, m = len(read), len(probe)
    if n == 0 or m == 0:
        return 0, 0, 0
    a = np.frombuffer(read.upper().encode(), dtype=np.uint8)
    b = np.frombuffer(probe.upper().encode(), dtype=np.uint8)

    prev = np.zeros(m + 1, dtype=np.int32)
    # traceback-free: track the best cell and recover the start by a
    # second, bounded backward pass
    best_score = 0
    best_i = best_j = 0
    H = np.zeros((n + 1, m + 1), dtype=np.int32)
    for i in range(1, n + 1):
        sub = np.where(b == a[i - 1], 1, -1).astype(np.int32)
        row = np.zeros(m + 1, dtype=np.int32)
        diag = prev[:-1] + sub
        up = prev[1:] - 1
        cand = np.maximum(np.maximum(diag, up), 0)
        # left-gap chains collapse into a running max:
        # H[i][j] = max_{k<=j-1}(cand[k] - (j-1-k))
        ar = np.arange(m, dtype=np.int32)
        row[1:] = np.maximum.accumulate(cand + ar) - ar
        H[i] = row
        mx = int(row.max())
        if mx > best_score:
            best_score = mx
            best_i = i
            best_j = int(row.argmax())
        prev = row

    if best_score == 0:
        return 0, 0, 0
    # backward walk to the start of the local alignment
    i, j = best_i, best_j
    while i > 0 and j > 0 and H[i][j] > 0:
        diag = H[i - 1][j - 1]
        sub = 1 if read[i - 1].upper() == probe[j - 1].upper() else -1
        if H[i][j] == diag + sub:
            i, j = i - 1, j - 1
        elif H[i][j] == H[i - 1][j] - 1:
            i -= 1
        elif H[i][j] == H[i][j - 1] - 1:
            j -= 1
        else:
            break
    return best_score, i, best_i


def local_align_batch_reference(reads, lengths, probe):
    """Plain version of ``local_align_batch`` (align.py:71-116): one step
    per read column, the within-row left-gap chain as a cummax with linear
    decay.  A row at or past a read's length leaves H as it was, and the
    end moves only on a strictly better row maximum."""
    B, L = reads.shape
    m = probe.shape[0]
    dev = reads.device
    i32 = torch.int32
    reads = reads.to(i32)
    probe = probe.to(i32)
    lengths = lengths.to(i32)
    ar = torch.arange(m, dtype=i32, device=dev)[None, :]
    zero = torch.zeros(B, 1, dtype=i32, device=dev)
    H = torch.zeros(B, m + 1, dtype=i32, device=dev)
    best = torch.zeros(B, dtype=i32, device=dev)
    best_end = torch.zeros(B, dtype=i32, device=dev)
    for t in range(L):
        sub = (probe[None, :] == reads[:, t, None]).to(i32) * 2 - 1
        cand = torch.maximum(H[:, :-1] + sub, H[:, 1:] - 1).clamp(min=0)
        row_tail = torch.cummax(cand + ar, dim=1).values - ar
        active = t < lengths
        H = torch.where(active[:, None], torch.cat([zero, row_tail], dim=1),
                        H)
        mx = H.max(dim=1).values
        better = active & (mx > best)
        best = torch.where(better, mx, best)
        best_end = torch.where(better, t + 1, best_end)
    return best, best_end


def local_align_batch(reads, lengths, probe):
    """Batched Smith-Waterman of one probe against many reads.

    reads: (B, L) int8 codes; lengths: (B,); probe: (m,) int8.
    Returns (score (B,), end (B,)) int32: best local-alignment score and
    the end position (exclusive) of the aligned window in each read.  The
    start position comes from a second pass on reversed reads (local
    alignment is reversal-symmetric): start = length - end_reversed.

    Scores match ``local_align`` / Bio.pairwise2 localms(1,-1,-1,-1).
    CUDA tensors go to the kernel (one launch), CPU tensors to the plain
    version."""
    if reads.is_cuda:
        return _kernels.local_align(reads.to(torch.int8), lengths,
                                    probe.to(torch.int8))
    if reads.device.type == "cpu":
        return local_align_batch_reference(reads, lengths, probe)
    raise ValueError(f"no local_align_batch for device {reads.device}")


def anchor_probe_batch(read_codes_list, probe_codes, device="cuda"):
    """Host wrapper: for each encoded read, the best (score, start, end) of
    the probe's local alignment: two batched passes (forward + reversed)
    on ``device``."""
    if not read_codes_list:
        return []
    batch, lengths = dna.pad_batch(read_codes_list, multiple=32)
    rev_rows = [r[::-1].copy() for r in read_codes_list]
    rev_batch, _ = dna.pad_batch(rev_rows, pad_to=batch.shape[1], multiple=1)
    probe = np.asarray(probe_codes, dtype=np.int8)
    rev_probe = probe[::-1].copy()
    on = lambda x: torch.as_tensor(x, device=device)
    score, end = local_align_batch(on(batch), on(lengths), on(probe))
    score_r, end_r = local_align_batch(on(rev_batch), on(lengths),
                                       on(rev_probe))
    score = score.cpu().numpy()
    end = end.cpu().numpy()
    start = lengths - end_r.cpu().numpy()
    return [(int(score[i]), int(start[i]), int(end[i]))
            for i in range(len(read_codes_list))]


def global_align_score(a: str, b: str) -> int:
    """Needleman-Wunsch score with (1,-1,-1,-1) — used for unique-flank
    estimation (reference: vntr_finder.py:78-96)."""
    from advntr_tpu_torch.models.msa import needleman_wunsch
    return needleman_wunsch(a, b)[2]
