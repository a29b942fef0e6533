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
(``local_align_batch_reference``) for CPU ones; ``local_align_passes``
runs several probes in one launch, as ``anchor_probes_batch`` does for
a locus's two flanks in both directions.  All of it is int32 arithmetic,
so they agree exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from advntr_tpu_torch import dna
from advntr_tpu_torch.ops import _kernels
from advntr_tpu_torch.utils.profiler import span


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


def local_align_wavefront_reference(reads, lengths, probe, chunks: int):
    """The scheme of csrc/local_align.cu in plain PyTorch, step by step, for
    the tests: each read in ``chunks`` chunks of ceil(L / chunks) rows, a
    warp each, each chunk started 2m rows early from H = 0; the warp's 32
    lanes hold the probe four positions each, lane k computing row s - k
    at step s from what lane k - 1 handed on at step s - 1; each lane keeps
    its maximum and the first row that reached it, the chunk takes the
    lanes' maximum and the first row among the lanes that hold it, and the
    chunks combine by the larger best, then the earlier end.  Equal to
    ``local_align_batch_reference`` (the tests hold both to the JAX scan)."""
    B, L = reads.shape
    m = probe.shape[0]
    i32, i64 = torch.int32, torch.int64
    if B == 0 or L == 0:
        return torch.zeros(B, dtype=i32), torch.zeros(B, dtype=i32)
    reads = reads.to(i64)
    rows = -(-L // chunks)
    nl = -(-m // 4)
    n = lengths.to(i64).clamp(0, L)[:, None]                    # (B, 1)
    c0 = torch.arange(chunks, dtype=i64)[None, :] * rows        # (1, NC)
    e = torch.minimum(c0 + rows, n)                             # (B, NC)
    r0 = (c0 - 2 * m).clamp(min=0).expand(B, chunks)
    lane = torch.arange(32, dtype=i64)
    pr = torch.full((128,), -128, dtype=i64)
    pr[:m] = probe.to(i64)
    pr = pr.view(32, 4)
    shape = (B, chunks, 32)
    T = torch.zeros(*shape, 4, dtype=i64)      # H[t-1, 4k+u+1]
    dgl = torch.zeros(shape, dtype=i64)        # H[t-1, 4k]
    out_h = torch.zeros(shape, dtype=i64)      # what a lane hands on
    out_b = torch.zeros(shape, dtype=i64)
    best = torch.zeros(shape, dtype=i64)
    first = torch.zeros(shape, dtype=i64)
    zero = torch.zeros(B, chunks, 1, dtype=i64)
    steps = int((e - r0).clamp(min=0).max()) + nl - 1
    for s in range(steps):
        left = torch.cat([zero, out_h[..., :-1]], dim=2)
        base0 = reads.gather(1, (r0 + s).clamp(max=L - 1))[..., None]
        base = torch.cat([base0, out_b[..., :-1]], dim=2)
        t = r0[..., None] + s - lane
        act = (s >= lane) & (t < e[..., None]) & (lane < nl)
        hl, dg, cells = left, dgl, []
        for u in range(4):
            sub = torch.where(pr[:, u] == base, 1, -1)
            cnd = torch.maximum(dg + sub, T[..., u] - 1).clamp(min=0)
            dg = T[..., u]
            hl = torch.maximum(hl - 1, cnd)
            cells.append(hl)
        cells = torch.stack(cells, dim=-1)
        mx = cells.max(dim=-1).values
        T = torch.where(act[..., None], cells, T)
        dgl = torch.where(act, left, dgl)
        out_h = torch.where(act, hl, out_h)
        out_b = torch.where(act, base, out_b)
        better = act & (t >= c0[..., None]) & (mx > best)
        best = torch.where(better, mx, best)
        first = torch.where(better, t, first)
    cb = best.max(dim=2).values                                 # (B, NC)
    cf = torch.where(best == cb[..., None], first, 1 << 40).min(dim=2).values
    ce = torch.where(cb > 0, cf + 1, 0)
    key = (cb << 32) | (0xFFFFFFFF - ce)
    k = key.max(dim=1).values
    return (k >> 32).to(i32), (0xFFFFFFFF - (k & 0xFFFFFFFF)).to(i32)


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
        score, end = _kernels.local_align_passes(
            reads.to(torch.int8)[None], lengths, probe.to(torch.int8)[None],
            [probe.shape[0]], [0])
        return score[0], end[0]
    if reads.device.type == "cpu":
        return local_align_batch_reference(reads, lengths, probe)
    raise ValueError(f"no local_align_batch for device {reads.device}")


def local_align_passes(reads, lengths, probes, probe_lengths, read_sets):
    """Several ``local_align_batch`` passes at once: reads (R, B, L),
    lengths (B,), probes (Q, stride); pass i aligns the first
    ``probe_lengths[i]`` bases of ``probes[i]`` against
    ``reads[read_sets[i]]``.  Returns (score (Q, B), end (Q, B)) int32.
    CUDA tensors go to the kernel in one launch, CPU tensors to the plain
    version pass by pass."""
    if reads.is_cuda:
        return _kernels.local_align_passes(reads, lengths, probes,
                                           probe_lengths, read_sets)
    if reads.device.type == "cpu":
        outs = [local_align_batch_reference(reads[r], lengths, probes[i, :m])
                for i, (m, r) in enumerate(zip(probe_lengths, read_sets))]
        return (torch.stack([s for s, _ in outs]),
                torch.stack([e for _, e in outs]))
    raise ValueError(f"no local_align_passes for device {reads.device}")


@span("advntr.anchor")
def anchor_probes_batch(read_codes_list, probes, device="cuda"):
    """Host wrapper: for each probe, for each encoded read, the best
    (score, start, end) of the probe's local alignment: every probe
    forward against the reads and reversed against the reversed reads,
    all in one ``local_align_passes`` call on ``device``."""
    if not read_codes_list:
        return [[] for _ in probes]
    batch, lengths = dna.pad_batch(read_codes_list, multiple=32)
    rev_rows = [r[::-1].copy() for r in read_codes_list]
    rev_batch, _ = dna.pad_batch(rev_rows, pad_to=batch.shape[1], multiple=1)
    probes = [np.asarray(p, dtype=np.int8) for p in probes]
    Q = len(probes)
    table = np.zeros((2 * Q, max(len(p) for p in probes)), dtype=np.int8)
    for i, p in enumerate(probes):
        table[i, :len(p)] = p
        table[Q + i, :len(p)] = p[::-1]
    on = lambda x: torch.as_tensor(x, device=device)
    score, end = local_align_passes(
        on(np.stack([batch, rev_batch])), on(lengths), on(table),
        [len(p) for p in probes] * 2, [0] * Q + [1] * Q)
    score, end = score.cpu().numpy(), end.cpu().numpy()
    start = lengths[None, :] - end[Q:]
    return [[(int(score[i, b]), int(start[i, b]), int(end[i, b]))
             for b in range(len(read_codes_list))] for i in range(Q)]


def global_align_score(a: str, b: str) -> int:
    """Needleman-Wunsch score with (1,-1,-1,-1) — used for unique-flank
    estimation (reference: vntr_finder.py:78-96)."""
    from advntr_tpu_torch.models.msa import needleman_wunsch
    return needleman_wunsch(a, b)[2]
