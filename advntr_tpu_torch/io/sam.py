"""SAM text format reader, yielding the same BamRead records as the BAM
reader (so the pipeline accepts .sam inputs like the reference's pysam 'r'
mode, vntr_finder.py:102-106)."""

from __future__ import annotations

import re
from typing import Iterator

from advntr_tpu_torch.io.bam import BamRead

_CIGAR_RE = re.compile(r"(\d+)([MIDNSHP=X])")
_OP_CODE = {op: i for i, op in enumerate("MIDNSHP=X")}


class SamReader:
    def __init__(self, path: str):
        self.path = path
        self.references: list[str] = []
        self.lengths: list[int] = []
        self.header_text = ""
        self._data_start = 0
        with open(path) as fh:
            header_lines = []
            pos = 0
            for line in fh:
                if not line.startswith("@"):
                    break
                header_lines.append(line)
                pos += len(line)
                if line.startswith("@SQ"):
                    name = length = None
                    for field in line.rstrip("\n").split("\t")[1:]:
                        if field.startswith("SN:"):
                            name = field[3:]
                        elif field.startswith("LN:"):
                            length = int(field[3:])
                    if name:
                        self.references.append(name)
                        self.lengths.append(length or 0)
            self.header_text = "".join(header_lines)
            self._data_start = pos

    def close(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass

    def _parse_line(self, line: str) -> BamRead | None:
        fields = line.rstrip("\n").split("\t")
        if len(fields) < 11:
            return None
        qname, flag, rname, pos, mapq, cigar_str = fields[:6]
        seq, qual = fields[9], fields[10]
        flag = int(flag)
        rid = self.references.index(rname) if rname in self.references else -1
        cigar = [(_OP_CODE[op], int(ln))
                 for ln, op in _CIGAR_RE.findall(cigar_str)] \
            if cigar_str != "*" else []
        quals = [ord(c) - 33 for c in qual] if qual != "*" else []
        return BamRead(qname, flag, rid, int(pos) - 1, int(mapq), cigar,
                       seq if seq != "*" else "", quals,
                       rname if rname != "*" else None)

    def __iter__(self) -> Iterator[BamRead]:
        with open(self.path) as fh:
            fh.seek(self._data_start)
            for line in fh:
                rec = self._parse_line(line)
                if rec is not None:
                    yield rec

    def head(self, n: int):
        out = []
        for rec in self:
            out.append(rec)
            if len(out) >= n:
                break
        return out

    def fetch(self, chromosome: str, start: int, end: int):
        for rec in self:
            if rec.is_unmapped or rec.reference_name != chromosome:
                continue
            ref_end = rec.reference_end or rec.reference_start + 1
            if rec.reference_start < end and ref_end > start:
                yield rec

    def fetch_unmapped(self):
        for rec in self:
            if rec.is_unmapped:
                yield rec


def open_alignment(path: str, reference_fasta: str | None = None):
    """BAM, SAM, or CRAM by extension (reference pysam mode dispatch,
    sam_utils.py:17; CRAM decoding needs the reference FASTA)."""
    if path.endswith(".sam"):
        return SamReader(path)
    if path.endswith(".cram"):
        from advntr_tpu_torch.io.cram import CramReader
        return CramReader(path, reference_fasta=reference_fasta)
    from advntr_tpu_torch.io.bam import BamReader
    return BamReader(path)
