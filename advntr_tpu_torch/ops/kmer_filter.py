"""Vectorized k-mer read-recruitment filter on the device.

Counterpart of advntr_tpu/ops/kmer_filter.py (an XLA pass there, so plain
tensor ops here): keywords of length k <= 15 are 2-bit packed into int32
codes; each read yields a rolling code per position; membership is a
binary search into the sorted keyword table; per-(read, locus) hit counts
accumulate with a scatter-add.  Keywords longer than k are matched by
their leading k-mer on the device and verified exactly on the host.
Behavioral contract: the reference's C++ filter, filtering/main.cc:229-331.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from advntr_tpu_torch import dna
from advntr_tpu_torch.utils.profiler import count, span

# reads per device chunk at most (the reference's default)
DEFAULT_CHUNK = 1024


@dataclasses.dataclass
class KeywordTable:
    k: int                     # device-matched prefix length
    codes: np.ndarray          # (K,) int32 sorted (with duplicates)
    locus_ids: np.ndarray      # (K,) int32 locus index per entry
    max_dup: int               # max entries sharing one code
    loci: list                 # locus index -> external locus id
    full_keywords: list        # entry index -> full keyword string
    needs_verify: bool         # any keyword longer than k


def encode_kmer(kmer: str) -> int:
    code = 0
    for ch in kmer:
        v = "ACGT".find(ch)
        if v < 0:
            return -1
        code = code * 4 + v
    return code


def build_keyword_table(keywords_per_locus: dict, k: int = 15) -> KeywordTable:
    """keywords_per_locus: {locus_id: iterable of keyword strings}."""
    loci = sorted(keywords_per_locus)
    entries = []  # (code, locus_index, full_keyword)
    needs_verify = False
    for li, locus in enumerate(loci):
        for kw in sorted(set(keywords_per_locus[locus])):
            kw = kw.upper()
            probe = kw[:k]
            if len(kw) > k:
                needs_verify = True
            if len(probe) < k:
                continue
            code = encode_kmer(probe)
            if code < 0:
                continue
            entries.append((code, li, kw))
    entries.sort(key=lambda e: (e[0], e[1]))
    codes = np.array([e[0] for e in entries], dtype=np.int32)
    locus_ids = np.array([e[1] for e in entries], dtype=np.int32)
    max_dup = 1
    if len(codes):
        _, counts = np.unique(codes, return_counts=True)
        max_dup = int(counts.max())
    return KeywordTable(k, codes, locus_ids, max_dup, loci,
                        [e[2] for e in entries], needs_verify)


def count_hits(codes_table, locus_ids, seqs, lengths, k: int, n_loci: int,
               max_dup: int):
    """Per-(read, locus) keyword hit counts (kmer_filter.py:77).

    seqs: (B, L) integer bases 0..3, 4 for N/padding.  Returns (B, n_loci)
    int32 on the device of ``seqs``."""
    B, L = seqs.shape
    n_pos = L - k + 1
    seqs = seqs.to(torch.int32)
    code = torch.zeros(B, n_pos, dtype=torch.int32, device=seqs.device)
    ok = torch.ones(B, n_pos, dtype=torch.bool, device=seqs.device)
    for j in range(k):
        win = seqs[:, j:j + n_pos]
        code = code * 4 + torch.where(win < 4, win, 0)
        ok &= win < 4
    pos = torch.arange(n_pos, device=seqs.device)[None, :]
    ok &= pos <= (lengths.to(torch.int64)[:, None] - k)
    K = codes_table.shape[0]
    lo = torch.searchsorted(codes_table, code)            # side="left"
    counts = torch.zeros(B * n_loci, dtype=torch.int32, device=seqs.device)
    row = torch.arange(B, device=seqs.device)[:, None] * n_loci
    for d in range(max_dup):
        idx = (lo + d).clamp(max=K - 1)
        hit = ok & (lo + d < K) & (codes_table[idx] == code)
        flat = (row + locus_ids[idx].long()).reshape(-1)
        counts.scatter_add_(0, flat, hit.reshape(-1).to(torch.int32))
    return counts.reshape(B, n_loci)


def count_topk(codes_table, locus_ids, seqs, lengths, k: int, n_loci: int,
               max_dup: int, top_m: int):
    """Hit counts compacted on the device to each read's top ``top_m``
    loci (kmer_filter.py:111).  Equal counts keep the lower locus index
    first, as jax.lax.top_k does, so the kept set and its order match the
    reference exactly."""
    counts = count_hits(codes_table, locus_ids, seqs, lengths, k, n_loci,
                        max_dup)
    # one distinct int64 key per (read, locus): the count in the high word,
    # the reversed locus index in the low word, so the largest keys are the
    # largest counts with the lower index first among equals
    key = counts.long()
    del counts
    key <<= 32
    key |= (n_loci - 1) - torch.arange(n_loci, device=key.device)
    top = torch.topk(key, top_m, dim=1).values
    idx = (n_loci - 1) - (top & 0xFFFFFFFF)
    return (top >> 32).to(torch.int32), idx.to(torch.int32)


def recruit_chunk(n_loci: int) -> int:
    """Reads per device chunk: the (B, n_loci) count plane stays under
    ~256 MB, and no chunk exceeds ADVNTR_TPU_RECRUIT_CHUNK reads
    (kmer_filter.py:159-177).  Raises ValueError where that variable is
    not an integer of at least 1, which would recruit nothing."""
    b_cap = max(32, (64 << 20) // max(1, n_loci))
    b_cap = 1 << (b_cap.bit_length() - 1)
    raw = os.environ.get("ADVNTR_TPU_RECRUIT_CHUNK", str(DEFAULT_CHUNK))
    try:
        limit = int(raw)
    except ValueError:
        limit = 0
    if limit < 1:
        raise ValueError("ADVNTR_TPU_RECRUIT_CHUNK must be an integer of at "
                         f"least 1 (reads a recruitment chunk); got {raw!r}")
    return min(b_cap, limit)


class RecruitmentFilter:
    """Multi-locus read recruitment with per-locus caps and ranking
    (counterpart of kmer_filter.py:127)."""

    def __init__(self, keywords_per_locus: dict, k: int = 15,
                 min_matches: int = 5, max_reads_per_locus: int = 2000,
                 top_m: int = 16, device="cuda"):
        self.table = build_keyword_table(keywords_per_locus, k)
        self.min_matches = min_matches
        self.max_reads_per_locus = max_reads_per_locus
        self.top_m = top_m
        self.device = torch.device(device)
        self._codes_dev = torch.as_tensor(self.table.codes, device=device)
        self._locus_dev = torch.as_tensor(self.table.locus_ids, device=device)
        self._hits: dict = {locus: {} for locus in self.table.loci}
        self._sequences: dict = {}
        # queued top-M results (n, name_of, seq_of, vals, idx),
        # collected in dispatch order so the device runs chunks back to back
        self._inflight: list = []
        self._full_by_locus: dict[int, list[str]] | None = None
        if self.table.needs_verify:
            self._full_by_locus = {}
            for li, kw in zip(self.table.locus_ids, self.table.full_keywords):
                self._full_by_locus.setdefault(int(li), []).append(kw)

    @span("advntr.recruit.filter")
    def process_batch(self, names: list[str], seqs: list[str]) -> None:
        count("recruit.reads", len(names))
        if not names or len(self.table.codes) == 0:
            return
        b_cap = recruit_chunk(len(self.table.loci))
        for s in range(0, len(names), b_cap):
            self._process_chunk(names[s:s + b_cap], seqs[s:s + b_cap])

    @span("advntr.recruit.filter")
    def process_packed(self, reads) -> None:
        """``process_batch`` for a batch of a BAM's records as the bulk
        scanner holds them (``io/bam_scan.PackedReads``): the same chunks
        and uploads, and a read's name and bases made into strings only
        where the filter keeps it."""
        count("recruit.reads", len(reads))
        if not len(reads) or len(self.table.codes) == 0:
            return
        b_cap = recruit_chunk(len(self.table.loci))
        for s in range(0, len(reads), b_cap):
            part = reads.take(s, s + b_cap)
            batch, lengths = part.codes(multiple=128)
            self._enqueue(batch, lengths, len(part), part.name, part.seq)

    def _process_chunk(self, names: list[str], seqs: list[str]) -> None:
        rows = [dna.encode(s.upper()) for s in seqs]
        batch, lengths = dna.pad_batch(rows, multiple=128)
        b_pad = 1 << (len(rows) - 1).bit_length()
        if b_pad != len(rows):
            batch = np.concatenate([batch, np.full(
                (b_pad - len(rows), batch.shape[1]), 4, dtype=batch.dtype)])
            lengths = np.concatenate(
                [lengths, np.zeros(b_pad - len(rows), dtype=lengths.dtype)])
        self._enqueue(batch, lengths, len(rows), names.__getitem__,
                      seqs.__getitem__)

    def _enqueue(self, batch: np.ndarray, lengths: np.ndarray, n: int,
                 name_of, seq_of) -> None:
        """Count one chunk's ``n`` reads (the rows of ``batch`` past ``n``
        are padding) on the device; ``name_of(b)`` and ``seq_of(b)`` give
        row ``b``'s strings where the filter keeps or recounts it."""
        if batch.shape[1] < self.table.k:
            return
        batch_d = torch.as_tensor(batch, device=self.device)
        lengths_d = torch.as_tensor(lengths, device=self.device)
        n_loci = len(self.table.loci)
        if self._full_by_locus is None and n_loci > self.top_m:
            vals, idx = count_topk(
                self._codes_dev, self._locus_dev, batch_d, lengths_d,
                self.table.k, n_loci, self.table.max_dup, self.top_m)
            self._inflight.append((n, name_of, seq_of, vals, idx))
            return
        counts = count_hits(
            self._codes_dev, self._locus_dev, batch_d, lengths_d,
            self.table.k, n_loci, self.table.max_dup).cpu().numpy()
        counts = counts[:n]
        if self._full_by_locus is not None:
            # long keywords: recount exactly on the host for device hits
            rb, rl = np.nonzero(counts)
            counts = np.zeros_like(counts)
            for b, li in zip(rb, rl):
                seq = seq_of(b).upper()
                c = 0
                for kw in self._full_by_locus.get(int(li), ()):
                    start = 0
                    while True:
                        p = seq.find(kw, start)
                        if p < 0:
                            break
                        c += 1
                        start = p + 1
                counts[b, li] = c
        hit_reads, hit_loci = np.nonzero(counts >= self.min_matches)
        for b, li in zip(hit_reads, hit_loci):
            self._add(self.table.loci[li], name_of(b), seq_of(b),
                      int(counts[b, li]))

    def _add(self, locus, name: str, seq: str, count: int) -> None:
        bucket = self._hits[locus]
        # overscan cap as in the reference (main.cc:280)
        if len(bucket) > self.max_reads_per_locus * 3:
            return
        bucket[name] = count
        self._sequences[name] = seq

    def _drain(self) -> None:
        for n, name_of, seq_of, vals, idx in self._inflight:
            vals = vals.cpu().numpy()[:n]
            idx = idx.cpu().numpy()[:n]
            rb, rm = np.nonzero(vals >= self.min_matches)
            for b, m in zip(rb, rm):
                self._add(self.table.loci[int(idx[b, m])], name_of(b),
                          seq_of(b), int(vals[b, m]))
        self._inflight = []

    @span("advntr.recruit.drain")
    def results(self):
        """{locus: [(read_name, count), ...] ranked by count desc, capped},
        plus {read_name: sequence} for every reported read."""
        self._drain()
        out = {}
        reported = {}
        for locus, bucket in self._hits.items():
            # rank by (count, name) descending (main.cc:314)
            ranked = sorted(bucket.items(), key=lambda kv: (kv[1], kv[0]),
                            reverse=True)[: self.max_reads_per_locus]
            out[locus] = ranked
            for name, _ in ranked:
                reported[name] = self._sequences[name]
        count("recruit.hits", len(reported))
        return out, reported
