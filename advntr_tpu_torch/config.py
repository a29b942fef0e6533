"""Immutable runtime configuration.

The reference keeps a module-global mutable settings namespace
(advntr/settings.py:1-44) that the command layer mutates at startup
(advntr/advntr_commands.py:66-104).  Here the same knob set is a frozen
dataclass threaded through the pipeline, so jitted code can treat values as
static and multi-host runs cannot diverge through hidden global state.
"""

from __future__ import annotations

import dataclasses
import os


@dataclasses.dataclass(frozen=True)
class Config:
    # Sequencing platform error model (reference: advntr_commands.py:66-71)
    max_error_rate: float = 0.05  # 0.05 Illumina, 0.30 PacBio/Nanopore

    # Read quality gates (reference: settings.py:24-26)
    quality_score_cutoff: int = 20
    low_quality_bp_to_discard_read: float = 0.10
    mapq_cutoff: int = 0

    # Recruitment filter (reference: filtering/main.cc:17-18, genome_analyzer.py:180)
    keyword_size: int = 15
    min_keyword_matches: int = 5
    max_reads_per_locus: int = 2000

    # Genotyping model (reference: vntr_finder.py:498)
    genotype_error_rate: float = 0.03

    # Frameshift (reference: settings.py:36)
    frameshift_vntrs: tuple[int, ...] = (25561, 519759)
    # Report forward-backward posterior indel support alongside the binomial
    # LR call (ops/posterior.py; a TPU-native capability beyond the
    # reference's Viterbi-path count, vntr_finder.py:256-309)
    frameshift_posterior: bool = True

    # Accuracy filter minima (reference: settings.py:42-44)
    accuracy_filter_min_left_flanking_size: int = 10
    accuracy_filter_min_right_flanking_size: int = 10
    accuracy_filter_sr_min_support: int = 3

    # Homology-aware spanning guard: raise per-side flank-bp minima to the
    # flank<->pattern homology run so tract-continuing flank matches never
    # count as spanning evidence.  No-op at non-homologous loci; set False
    # for strict reference-default gate parity (engine/finder.py:__init__).
    spanning_homology_guard: bool = True

    # Model DB paths (reference: settings.py:10-13)
    models_file: str = "vntr_data/hg19_selected_VNTRs_Illumina.db"

    # Optional per-locus DNN recruitment models (reference: settings.py:39)
    dnn_models_dir: str = "dnn_models"

    # Optional trained-HMM JSON cache (pomegranate format) — reference
    # settings.py:9 USE_TRAINED_HMMS + TRAINED_HMMS_DIR, consumed at
    # vntr_finder.py:117-138; None disables (the reference default)
    trained_hmms_dir: str | None = None

    # Host-side parallelism for IO/pipelining
    io_threads: int = max(1, (os.cpu_count() or 2) - 1)

    # Device batching
    read_batch_size: int = 512
    min_read_length: int | None = None

    def with_platform(self, pacbio: bool = False, nanopore: bool = False) -> "Config":
        err = 0.3 if (pacbio or nanopore) else 0.05
        return dataclasses.replace(self, max_error_rate=err)


DEFAULT_CONFIG = Config()
