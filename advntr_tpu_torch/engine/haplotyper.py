"""PacBio diploid haplotyping: cluster spanning reads into two haplotypes
and produce error-corrected consensus sequences.

Capability-equivalent to the reference PacBioHaplotyper
(advntr/pacbio_haplotyper.py:14-109) + hierarchical_clustering.py +
distance.py, with the MUSCLE subprocess replaced by the internal center-star
MSA.
"""

from __future__ import annotations

import logging

from advntr_tpu_torch.models.msa import center_star_msa


def hamming(s1: str, s2: str) -> int:
    return sum(1 for a, b in zip(s1, s2) if a != b)


def _clusters_dist(c1, c2, dist):
    total = sum(dist[i][j] for i in c1 for j in c2)
    return total / (len(c1) * len(c2))


def hierarchical_clustering(k: int, dist) -> list[list[int]]:
    """Average-linkage agglomerative clustering down to k clusters
    (reference semantics: hierarchical_clustering.py:26-34)."""
    clusters = [[i] for i in range(len(dist))]
    while len(clusters) > k:
        best = None
        closest = (0, 0)
        for i in range(len(clusters)):
            for j in range(len(clusters)):
                if i == j:
                    continue
                d = _clusters_dist(clusters[i], clusters[j], dist)
                if best is None or d < best:
                    best = d
                    closest = (i, j)
        i, j = sorted(closest)
        merged = clusters[i] + clusters[j]
        clusters.append(merged)
        clusters = clusters[:j] + clusters[j + 1:]
        clusters = clusters[:i] + clusters[i + 1:]
    return clusters


class PacBioHaplotyper:
    def __init__(self, reads: list[str]):
        logging.debug("Number of reads for finding haplotypes: %s", len(reads))
        self.reads = [read.upper() for read in reads]

    def get_error_corrected_haplotypes(self, number_of_clusters: int = 2):
        if len(self.reads) < 2:
            return list(self.reads)
        haplotypes = []
        clusters = self.get_read_clusters(number_of_clusters)
        smaller = min(len(c) for c in clusters)
        larger = max(len(c) for c in clusters)
        homozygous = larger >= 7 * smaller  # reference: pacbio_haplotyper.py:31
        for cluster in clusters:
            if len(cluster) == smaller and homozygous:
                continue
            if len(cluster) < 2:
                haplotypes.append(cluster[0])
                continue
            aligned = center_star_msa(cluster)
            haplotypes.append(self.consensus(aligned))
        if len(haplotypes) < 2 and haplotypes:
            haplotypes.append(haplotypes[0])
        return haplotypes

    @staticmethod
    def consensus(aligned_reads: list[str]) -> str:
        """Column-majority consensus; ties resolved against the gap
        (reference semantics: pacbio_haplotyper.py:52-71)."""
        seq = []
        for i in range(len(aligned_reads[0])):
            bins: dict[str, int] = {}
            for row in aligned_reads:
                bins[row[i]] = bins.get(row[i], 0) + 1
            ranked = sorted(bins.items(), key=lambda kv: (kv[1], kv[0] != "-"))
            best = ranked[-1][0]
            if best != "-":
                seq.append(best)
        return "".join(seq)

    def get_read_clusters(self, number_of_clusters: int = 2):
        aligned = center_star_msa(self.reads)
        informative = self.get_informative_columns(aligned)
        dist = [[hamming(a, b) for b in informative] for a in informative]
        clusters = hierarchical_clustering(number_of_clusters, dist)
        return [[self.reads[i] for i in cluster] for cluster in clusters]

    @staticmethod
    def get_informative_columns(aligned_reads: list[str]) -> list[str]:
        """Columns where the majority base covers <= 70% of reads
        (reference semantics: pacbio_haplotyper.py:93-109)."""
        result = ["" for _ in aligned_reads]
        for col in range(len(aligned_reads[0]) - 1):
            bins: dict[str, int] = {}
            for row in aligned_reads:
                bins[row[col]] = bins.get(row[col], 0) + 1
            if max(bins.values()) <= len(aligned_reads) * 0.7:
                for i, row in enumerate(aligned_reads):
                    result[i] += row[col]
        return result
