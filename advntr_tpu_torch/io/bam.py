"""Native BAM reader/writer with BAI random access (no pysam/samtools).

The reference leans on pysam for region fetches (vntr_finder.py:727) and
shells out to samtools for unmapped-read extraction (sam_utils.py:18-21).
This module implements the BAM binary format and the BAI binning index
directly on top of the BGZF layer, giving the pipeline:

- sequential full scans (unmapped-read streaming)
- indexed region fetches (mapped candidate reads per locus)
- a writer + indexer so tests can fabricate BAM fixtures in-process
"""

from __future__ import annotations

import dataclasses
import os
import struct

from advntr_tpu_torch.io.bgzf import BgzfReader, BgzfWriter

_SEQ_CODES = "=ACMGRSVTWYHKDBN"
_CIGAR_OPS = "MIDNSHP=X"
# ops that consume the reference
_REF_CONSUMING = {0, 2, 3, 7, 8}


@dataclasses.dataclass
class BamRead:
    query_name: str
    flag: int
    reference_id: int
    reference_start: int  # 0-based
    mapq: int
    cigar: list[tuple[int, int]]  # (op, length)
    seq: str
    qual: list[int]
    reference_name: str | None = None

    @property
    def is_unmapped(self) -> bool:
        return bool(self.flag & 4)

    @property
    def is_duplicate(self) -> bool:
        return bool(self.flag & 1024)

    @property
    def is_secondary(self) -> bool:
        return bool(self.flag & 256)

    @property
    def is_supplementary(self) -> bool:
        return bool(self.flag & 2048)

    @property
    def is_reverse(self) -> bool:
        return bool(self.flag & 16)

    @property
    def reference_end(self):
        if self.is_unmapped:
            return None
        span = sum(ln for op, ln in self.cigar if op in _REF_CONSUMING)
        return self.reference_start + (span or len(self.seq))

    def get_reference_positions(self, full_length: bool = False):
        """Reference position per read base (None for clips/insertions when
        full_length)."""
        out = []
        rpos = self.reference_start
        for op, ln in self.cigar or [(0, len(self.seq))]:
            if op in (0, 7, 8):  # M, =, X
                out.extend(range(rpos, rpos + ln))
                rpos += ln
            elif op in (1, 4):   # I, S consume query only
                if full_length:
                    out.extend([None] * ln)
            elif op in (2, 3):   # D, N consume reference only
                rpos += ln
        return out


def _parse_record(data: bytes, references: list[str]) -> BamRead:
    (ref_id, pos, l_read_name, mapq, _bin, n_cigar_op, flag, l_seq,
     _next_ref, _next_pos, _tlen) = struct.unpack_from("<iiBBHHHiiii", data)
    off = 32
    name = data[off:off + l_read_name - 1].decode()
    off += l_read_name
    cigar = []
    for _ in range(n_cigar_op):
        v = struct.unpack_from("<I", data, off)[0]
        cigar.append((v & 0xF, v >> 4))
        off += 4
    nbytes = (l_seq + 1) // 2
    seq_chars = []
    for i in range(l_seq):
        b = data[off + i // 2]
        code = (b >> 4) if i % 2 == 0 else (b & 0xF)
        seq_chars.append(_SEQ_CODES[code])
    off += nbytes
    qual = list(data[off:off + l_seq])
    ref_name = references[ref_id] if 0 <= ref_id < len(references) else None
    return BamRead(name, flag, ref_id, pos, mapq, cigar,
                   "".join(seq_chars), qual, ref_name)


class BamReader:
    def __init__(self, path: str):
        self.path = path
        self._bgzf = BgzfReader(path)
        magic = self._bgzf.read(4)
        if magic != b"BAM\x01":
            raise ValueError(f"{path}: not a BAM file")
        l_text = struct.unpack("<i", self._bgzf.read(4))[0]
        self.header_text = self._bgzf.read(l_text).decode(errors="replace")
        n_ref = struct.unpack("<i", self._bgzf.read(4))[0]
        self.references: list[str] = []
        self.lengths: list[int] = []
        for _ in range(n_ref):
            l_name = struct.unpack("<i", self._bgzf.read(4))[0]
            self.references.append(self._bgzf.read(l_name)[:-1].decode())
            self.lengths.append(struct.unpack("<i", self._bgzf.read(4))[0])
        self._data_voffset = self._bgzf.tell_virtual()
        self._index = None

    def close(self):
        self._bgzf.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _read_record(self):
        size_bytes = self._bgzf.read(4)
        if len(size_bytes) < 4:
            return None
        block_size = struct.unpack("<i", size_bytes)[0]
        data = self._bgzf.read(block_size)
        return _parse_record(data, self.references)

    def __iter__(self):
        self._bgzf.seek_virtual(self._data_voffset)
        while True:
            rec = self._read_record()
            if rec is None:
                return
            yield rec

    def head(self, n: int):
        out = []
        for rec in self:
            out.append(rec)
            if len(out) >= n:
                break
        return out

    # ---- indexed fetch ----------------------------------------------------

    def _load_index(self):
        if self._index is None:
            for cand in (self.path + ".bai", self.path[:-4] + ".bai"):
                if os.path.exists(cand):
                    self._index = BaiIndex.load(cand)
                    break
            if self._index is None:
                raise FileNotFoundError(f"no BAI index for {self.path}")
        return self._index

    def fetch(self, chromosome: str, start: int, end: int):
        """Yield reads overlapping [start, end) on chromosome (0-based)."""
        if chromosome not in self.references:
            return
        rid = self.references.index(chromosome)
        index = self._load_index()
        for voff in index.candidate_offsets(rid, start, end):
            self._bgzf.seek_virtual(voff)
            while True:
                rec = self._read_record()
                if rec is None:
                    return
                if rec.reference_id != rid or rec.reference_start >= end:
                    break
                ref_end = rec.reference_end or rec.reference_start + 1
                if not rec.is_unmapped and ref_end > start:
                    yield rec
            break  # linear scan from the first candidate offset suffices

    def fetch_unmapped(self):
        for rec in self:
            if rec.is_unmapped:
                yield rec


# ---------------------------------------------------------------------------
# BAI index
# ---------------------------------------------------------------------------

def _reg2bin(beg: int, end: int) -> int:
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def _reg2bins(beg: int, end: int) -> list[int]:
    bins = [0]
    end -= 1
    for shift, base in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
        bins.extend(range(base + (beg >> shift), base + (end >> shift) + 1))
    return bins


class BaiIndex:
    def __init__(self, bins_per_ref, intervals_per_ref):
        self.bins_per_ref = bins_per_ref          # [ {bin: [(beg,end)...]} ]
        self.intervals_per_ref = intervals_per_ref  # linear index (16kb)

    @classmethod
    def load(cls, path: str) -> "BaiIndex":
        with open(path, "rb") as fh:
            data = fh.read()
        if data[:4] != b"BAI\x01":
            raise ValueError("bad BAI magic")
        off = 4
        n_ref = struct.unpack_from("<i", data, off)[0]
        off += 4
        bins_per_ref = []
        intervals_per_ref = []
        for _ in range(n_ref):
            n_bin = struct.unpack_from("<i", data, off)[0]
            off += 4
            bins = {}
            for _ in range(n_bin):
                bin_id, n_chunk = struct.unpack_from("<Ii", data, off)
                off += 8
                chunks = []
                for _ in range(n_chunk):
                    beg, end = struct.unpack_from("<QQ", data, off)
                    off += 16
                    chunks.append((beg, end))
                bins[bin_id] = chunks
            n_intv = struct.unpack_from("<i", data, off)[0]
            off += 4
            ioffs = list(struct.unpack_from(f"<{n_intv}Q", data, off))
            off += 8 * n_intv
            bins_per_ref.append(bins)
            intervals_per_ref.append(ioffs)
        return cls(bins_per_ref, intervals_per_ref)

    def save(self, path: str) -> None:
        out = bytearray(b"BAI\x01")
        out += struct.pack("<i", len(self.bins_per_ref))
        for bins, intervals in zip(self.bins_per_ref, self.intervals_per_ref):
            out += struct.pack("<i", len(bins))
            for bin_id, chunks in bins.items():
                out += struct.pack("<Ii", bin_id, len(chunks))
                for beg, end in chunks:
                    out += struct.pack("<QQ", beg, end)
            out += struct.pack("<i", len(intervals))
            out += struct.pack(f"<{len(intervals)}Q", *intervals)
        with open(path, "wb") as fh:
            fh.write(bytes(out))

    def candidate_offsets(self, rid: int, start: int, end: int):
        if rid >= len(self.bins_per_ref):
            return []
        bins = self.bins_per_ref[rid]
        intervals = self.intervals_per_ref[rid]
        min_voff = 0
        win = start >> 14
        if win < len(intervals):
            min_voff = intervals[win]
        offsets = []
        for b in _reg2bins(start, max(end, start + 1)):
            for beg, cend in bins.get(b, ()):
                if cend > min_voff:
                    offsets.append(max(beg, min_voff))
        return sorted(offsets)


def build_bai(bam_path: str, out_path: str | None = None) -> str:
    """Index a (coordinate-sorted) BAM file."""
    out_path = out_path or bam_path + ".bai"
    reader = BamReader(bam_path)
    n_ref = len(reader.references)
    bins_per_ref = [dict() for _ in range(n_ref)]
    intervals_per_ref = [[] for _ in range(n_ref)]

    bgzf = reader._bgzf
    bgzf.seek_virtual(reader._data_voffset)
    while True:
        voff_start = bgzf.tell_virtual()
        rec = reader._read_record()
        if rec is None:
            break
        voff_end = bgzf.tell_virtual()
        if rec.is_unmapped or rec.reference_id < 0:
            continue
        rid = rec.reference_id
        beg = rec.reference_start
        end = rec.reference_end or beg + 1
        b = _reg2bin(beg, end)
        bins_per_ref[rid].setdefault(b, [])
        chunks = bins_per_ref[rid][b]
        if chunks and chunks[-1][1] == voff_start:
            chunks[-1] = (chunks[-1][0], voff_end)
        else:
            chunks.append((voff_start, voff_end))
        intervals = intervals_per_ref[rid]
        for win in range(beg >> 14, ((end - 1) >> 14) + 1):
            while len(intervals) <= win:
                intervals.append(0)
            if intervals[win] == 0 or voff_start < intervals[win]:
                intervals[win] = voff_start
    reader.close()
    index = BaiIndex(bins_per_ref, intervals_per_ref)
    index.save(out_path)
    return out_path


# ---------------------------------------------------------------------------
# writer (tests/fixtures)
# ---------------------------------------------------------------------------

class BamWriter:
    def __init__(self, path: str, references: list[str], lengths: list[int],
                 header_text: str = ""):
        self._bgzf = BgzfWriter(path)
        self.references = references
        payload = bytearray(b"BAM\x01")
        text = header_text.encode()
        payload += struct.pack("<i", len(text)) + text
        payload += struct.pack("<i", len(references))
        for name, length in zip(references, lengths):
            nb = name.encode() + b"\x00"
            payload += struct.pack("<i", len(nb)) + nb
            payload += struct.pack("<i", length)
        self._bgzf.write(bytes(payload))

    def write(self, read: BamRead) -> None:
        name = read.query_name.encode() + b"\x00"
        l_seq = len(read.seq)
        cigar = read.cigar or []
        beg = read.reference_start if read.reference_start >= 0 else -1
        end = read.reference_end if not read.is_unmapped else (beg + 1)
        rec = bytearray()
        rec += struct.pack(
            "<iiBBHHHiiii", read.reference_id, beg, len(name), read.mapq,
            _reg2bin(max(beg, 0), max(end or 1, 1)), len(cigar), read.flag,
            l_seq, -1, -1, 0)
        rec += name
        for op, ln in cigar:
            rec += struct.pack("<I", (ln << 4) | op)
        code_of = {c: i for i, c in enumerate(_SEQ_CODES)}
        packed = bytearray((l_seq + 1) // 2)
        for i, ch in enumerate(read.seq):
            c = code_of.get(ch, 15)
            if i % 2 == 0:
                packed[i // 2] |= c << 4
            else:
                packed[i // 2] |= c
        rec += packed
        rec += bytes(read.qual or [0xFF] * l_seq)
        self._bgzf.write(struct.pack("<i", len(rec)) + bytes(rec))

    def close(self):
        self._bgzf.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def get_reference_genome_style(references: list[str]) -> str | None:
    """'HG19' when chromosome names carry the chr prefix, else 'GRCh37'
    (reference semantics: sam_utils.py:32-39)."""
    result = None
    if "1" in references:
        result = "GRCh37"
    for ref in references:
        if ref.startswith("chr"):
            result = "HG19"
    return result
