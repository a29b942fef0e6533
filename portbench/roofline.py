"""The work of the algorithm, counted from the inputs and the harness's own
model sizes, and the card's peaks.  Only real reads and real columns count,
never padding; each input byte is read once and each output byte written
once, whatever an implementation reads again or keeps in between.

Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet: 67 TFLOP/s in float32
outside the tensor cores (the scores are float32 sums and maxima) and
3.35 TB/s of HBM3, at the full 700 W; the card's ``power.limit`` is
reported beside every share.
"""

from __future__ import annotations

PEAK_OPS = 67e12
PEAK_BYTES = 3.35e12
ALIGN_OPS_PER_CELL = 12      # a probe position and read column
STAT_BYTES = 8 * 4           # logp and seven counts, a scored read


def read_matcher_transitions(f_left: int, f_right: int, motif: int,
                             copies: int) -> int:
    """Live edges of adVNTR's read-matcher HMM (reference/hmm.py): each
    flank matcher 10 F + 2, each repeat unit 9 W + 3, the connectors
    11 + W + 2 C, and one exit edge from every repeat match, C W."""
    return (10 * f_left + 2) + (10 * f_right + 2) + copies * (9 * motif + 3) \
        + 11 + motif + 2 * copies + copies * motif


def emitting_states(f_left: int, f_right: int, motif: int,
                    copies: int) -> int:
    return (2 * f_left + 1) + (2 * f_right + 1) + copies * (2 * motif + 1)


def decode_work(f_left: int, f_right: int, motif: int, copies: int,
                row_lengths) -> tuple[float, float]:
    """(operations, bytes) of decoding the rows of one locus: an add and a
    max per transition and read column; the reads, the model's float32
    weights and emissions once, and each read's statistics."""
    T = read_matcher_transitions(f_left, f_right, motif, copies)
    cols = float(sum(int(n) for n in row_lengths))
    table = 4 * (T + 4 * emitting_states(f_left, f_right, motif, copies))
    return 2.0 * T * cols, cols + table + STAT_BYTES * len(row_lengths)


def align_work(read_lengths, probe_lengths) -> tuple[float, float]:
    """(operations, bytes) of anchoring: every probe along every read
    forward and, for the start, reversed; the reads and probes once, a
    score and an end per read and pass."""
    cols = float(sum(int(n) for n in read_lengths))
    probes = float(sum(int(m) for m in probe_lengths))
    passes = 2 * len(probe_lengths)
    ops = ALIGN_OPS_PER_CELL * cols * probes * 2
    return ops, cols + probes + 8 * passes * len(read_lengths)


def bound_seconds(ops: float, nbytes: float) -> float:
    return max(ops / PEAK_OPS, nbytes / PEAK_BYTES)
