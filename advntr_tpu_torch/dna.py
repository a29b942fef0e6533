"""DNA sequence utilities: 2-bit encoding, reverse complement, batching.

Sequences travel through the device pipeline as int8 arrays with
A=0, C=1, G=2, T=3 (anything else = 4, which callers must mask out or reject
upstream — reads containing N are rejected before Viterbi, matching the
reference's gate at vntr_finder.py:237).
"""

from __future__ import annotations

import numpy as np

A, C, G, T = 0, 1, 2, 3
BASES = "ACGT"

_ENCODE = np.full(256, 4, dtype=np.int8)
for _i, _b in enumerate(BASES):
    _ENCODE[ord(_b)] = _i
    _ENCODE[ord(_b.lower())] = _i

_COMPLEMENT = {"A": "T", "C": "G", "G": "C", "T": "A", "N": "N",
               "a": "t", "c": "g", "g": "c", "t": "a", "n": "n"}


def encode(seq: str) -> np.ndarray:
    """Encode an ACGT string to int8 codes (non-ACGT -> 4)."""
    return _ENCODE[np.frombuffer(seq.encode("ascii"), dtype=np.uint8)]


def decode(codes: np.ndarray) -> str:
    return "".join(BASES[c] if 0 <= c < 4 else "N" for c in codes)


def has_n(seq: str) -> bool:
    return "N" in seq or "n" in seq


def revcomp(seq: str) -> str:
    return "".join(_COMPLEMENT.get(ch, "N") for ch in reversed(seq))


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    out = codes[::-1].copy()
    mask = out < 4
    out[mask] = 3 - out[mask]
    return out


def pad_batch(seqs: list[np.ndarray], pad_to: int | None = None,
              multiple: int = 128) -> tuple[np.ndarray, np.ndarray]:
    """Pad a list of encoded reads into a dense (B, L) int8 batch + lengths.

    L is rounded up to `multiple` for TPU lane alignment. Padding value is 0
    (the kernel masks out steps past each read's length).
    """
    lengths = np.array([len(s) for s in seqs], dtype=np.int32)
    max_len = int(lengths.max()) if len(seqs) else 0
    if pad_to is not None:
        max_len = max(max_len, pad_to)
    if multiple > 1:
        max_len = ((max_len + multiple - 1) // multiple) * multiple
    batch = np.zeros((len(seqs), max_len), dtype=np.int8)
    for i, s in enumerate(seqs):
        batch[i, : len(s)] = s
    return batch, lengths
