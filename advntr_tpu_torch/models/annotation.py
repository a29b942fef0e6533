"""Gene-annotation assignment for DB construction (offline path).

Capability-equivalent to the reference advntr/vntr_annotation.py:12-282:
given UCSC/RefSeq-style BED tracks (coding exons, introns, 5'/3' UTRs,
genes) assign each VNTR a gene name and a {Coding, UTR, Intron, Promoter}
annotation.  Interval lookups use sorted arrays + binary search instead of
linear scans.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

PROMOTER_RANGE = 500


def intersect(s1: int, e1: int, s2: int, e2: int) -> bool:
    return s1 <= e2 and s2 <= e1


def include(s1: int, e1: int, vntr_s: int, vntr_e: int) -> bool:
    return s1 <= vntr_s <= vntr_e <= e1


def read_bed_track(path: str) -> dict[str, list[tuple]]:
    """{chromosome: sorted [(start, end, identifier, strand, *rest)]}"""
    track: dict[str, list[tuple]] = defaultdict(list)
    with open(path) as fh:
        for line in fh:
            fields = line.strip().split()
            if len(fields) < 4 or line.startswith(("#", "track")):
                continue
            chrom, start, end, ident = fields[:4]
            strand = fields[5] if len(fields) > 5 else "+"
            track[chrom].append((int(start), int(end), ident, strand))
    for chrom in track:
        track[chrom].sort()
    return dict(track)


def read_name_mapping(path: str) -> dict[str, str]:
    """Two-column identifier -> gene-name file (e.g. Refseq2Gene.txt)."""
    mapping = {}
    with open(path) as fh:
        for line in fh:
            fields = line.strip().split()
            if len(fields) >= 2:
                mapping[fields[0]] = fields[1]
    return mapping


class AnnotationAssigner:
    def __init__(self, genes, exons, introns, utr3, utr5, name_mapping):
        self.genes = genes
        self.exons = exons
        self.introns = introns
        self.utr3 = utr3
        self.utr5 = utr5
        self.name_mapping = name_mapping
        self._starts = {id(t): {c: [iv[0] for iv in ivs]
                                for c, ivs in t.items()}
                        for t in (genes, exons, introns, utr3, utr5)}

    def _gene_name(self, identifier: str) -> str:
        return self.name_mapping.get(identifier.split(".")[0].split("_")[0],
                                     self.name_mapping.get(
                                         identifier.split(".")[0], "None"))

    def _first_hit(self, track, chrom, start, end, pad: int = 0):
        intervals = track.get(chrom, [])
        starts = self._starts[id(track)].get(chrom, [])
        # candidates whose start <= end+pad; scan a bounded window backwards
        hi = bisect.bisect_right(starts, end + pad)
        for i in range(max(0, hi - 512), hi):
            s, e, ident, strand = intervals[i][:4]
            if intersect(s - pad, e + pad, start, end):
                return intervals[i]
        return None

    def annotate(self, chrom: str, start: int, end: int):
        """(gene_name, annotation) with the reference's precedence:
        Coding > UTR(5') > UTR(3') > Intron > Promoter."""
        for track, label in ((self.exons, "Coding"), (self.utr5, "UTR"),
                             (self.utr3, "UTR"), (self.introns, "Intron")):
            hit = self._first_hit(track, chrom, start, end)
            if hit is not None:
                return self._gene_name(hit[2]), label
        # promoter: PROMOTER_RANGE upstream of the gene start (strand-aware)
        for s, e, ident, strand in self.genes.get(chrom, []):
            if strand == "-":
                ps, pe = e, e + PROMOTER_RANGE
            else:
                ps, pe = s - PROMOTER_RANGE, s
            if intersect(ps, pe, start, end):
                return self._gene_name(ident), "Promoter"
            if ps - PROMOTER_RANGE > end:
                break
        return "None", "None"

    def is_close_to_gene(self, chrom: str, start: int, end: int,
                         pad: int = 1000) -> bool:
        return self._first_hit(self.genes, chrom, start, end, pad) is not None
