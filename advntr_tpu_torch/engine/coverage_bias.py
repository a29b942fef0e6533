"""GC-content coverage-bias model for the expansion/coverage workload.

Capability-equivalent to the reference CoverageBiasDetector /
CoverageCorrector (advntr/coverage_bias.py:12-125): per-100bp-window
coverage histograms bucketed by GC content, used to rescale an observed
VNTR coverage before RU estimation.  Window accumulation is vectorized with
numpy instead of the reference's per-read recursive Python walk.
"""

from __future__ import annotations

import logging
import sys
from math import sqrt

import numpy as np

GC_CONTENT_WINDOW_SIZE = 100
GC_CONTENT_BINS = 10
OUTLIER_COVERAGE = 200


def get_gc_content(s: str) -> float:
    if not s:
        return 0.0
    arr = np.frombuffer(s.upper().encode(), dtype=np.uint8)
    return float(((arr == ord("G")) | (arr == ord("C"))).mean())


class CoverageBiasDetector:
    """Coverage distribution per GC-content bin from an alignment file."""

    def __init__(self, alignment_file: str, chromosome: str | None = None,
                 reference_sequences: dict[str, str] | None = None):
        self.alignment_file = alignment_file
        self.chromosome = chromosome
        self.reference_sequences = reference_sequences or {}

    def gc_of_windows(self, chromosome_seq: str) -> np.ndarray:
        n = len(chromosome_seq) // GC_CONTENT_WINDOW_SIZE
        arr = np.frombuffer(
            chromosome_seq[: n * GC_CONTENT_WINDOW_SIZE].upper().encode(),
            dtype=np.uint8)
        gc = ((arr == ord("G")) | (arr == ord("C"))).astype(np.float64)
        return gc.reshape(n, GC_CONTENT_WINDOW_SIZE).mean(axis=1)

    def covered_bp_of_windows(self, chromosome: str,
                              n_windows: int) -> np.ndarray:
        from advntr_tpu_torch.io.bam import BamReader
        covered = np.zeros(n_windows + 1, dtype=np.int64)
        with BamReader(self.alignment_file) as bam:
            for read in bam:
                if read.is_unmapped:
                    continue
                name = read.reference_name or ""
                if not name.startswith("chr"):
                    name = "chr" + name
                if name != chromosome:
                    continue
                start = read.reference_start
                end = read.reference_end or start + len(read.seq)
                # distribute covered bp over windows (vectorized span split)
                w0 = start // GC_CONTENT_WINDOW_SIZE
                w1 = (end - 1) // GC_CONTENT_WINDOW_SIZE
                for w in range(w0, min(w1, n_windows - 1) + 1):
                    lo = max(w * GC_CONTENT_WINDOW_SIZE, start)
                    hi = min((w + 1) * GC_CONTENT_WINDOW_SIZE, end)
                    covered[w] += hi - lo
        return covered[:n_windows]

    def get_gc_content_coverage_map(self) -> dict[int, list[float]]:
        gc_coverage_map: dict[int, list[float]] = {}
        for chromosome, seq in self.reference_sequences.items():
            if self.chromosome and chromosome != self.chromosome:
                continue
            gcs = self.gc_of_windows(seq)
            covered = self.covered_bp_of_windows(chromosome, len(gcs))
            coverage = covered / GC_CONTENT_WINDOW_SIZE
            bins = (gcs * GC_CONTENT_BINS).astype(int)
            for b, cov in zip(bins, coverage):
                # windows never touched by a read are absent from the
                # reference's map too (it only creates entries per read)
                if cov == 0 or cov > OUTLIER_COVERAGE:
                    continue
                gc_coverage_map.setdefault(int(b), []).append(float(cov))
        return gc_coverage_map


class CoverageCorrector:
    def __init__(self, gc_coverage_map: dict[int, list[float]]):
        self.gc_coverage_map = gc_coverage_map

    @staticmethod
    def get_gc_bin_index(gc_content: float) -> int:
        return int(gc_content * GC_CONTENT_BINS - sys.float_info.epsilon * 10)

    def get_sequencing_mean_coverage(self) -> float:
        all_cov = [c for covs in self.gc_coverage_map.values() for c in covs]
        return sum(all_cov) / float(len(all_cov))

    def get_mean_coverage_of_gc_content(self, gc_content: float) -> float:
        covs = self.gc_coverage_map[self.get_gc_bin_index(gc_content)]
        return sum(covs) / float(len(covs))

    def get_mean_coverage_error_bar_of_gc_content(self, gc_content) -> float:
        covs = self.gc_coverage_map[self.get_gc_bin_index(gc_content)]
        return float(np.std(np.array(covs)) / sqrt(len(covs)))

    def get_scaled_coverage(self, reference_vntr,
                            observed_coverage: float) -> float:
        gc_content = get_gc_content(
            "".join(reference_vntr.get_repeat_segments()))
        scale_ratio = (self.get_sequencing_mean_coverage() /
                       self.get_mean_coverage_of_gc_content(gc_content))
        logging.debug("GC content and scale ratio: %s %s",
                      gc_content, scale_ratio)
        return observed_coverage * scale_ratio
