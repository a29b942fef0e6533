"""Model-DB construction pipeline from VNTRseek output (offline).

Capability-equivalent to the reference's DB-construction path
(advntr/models.py:21-117, 164-186): parse VNTRseek repeat predictions,
drop out-of-range motifs, merge/skip overlapping loci, decompose each locus
against the repeat-finder HMM, and persist to the SQLite model DB.
"""

from __future__ import annotations

import logging

from advntr_tpu_torch.models.reference_vntr import ReferenceVNTR


def load_unprocessed_vntrseek_data(vntrseek_output: str,
                                   chromosome_seq: str,
                                   chromosome: str | None = None,
                                   annotation_assigner=None):
    """Parse a VNTRseek output table into unprocessed ReferenceVNTRs.

    Lines: ``repeats _ pattern chromosome start`` (1-based starts); motifs
    outside 6..100bp are dropped (reference: models.py:30-41).
    """
    vntrs = []
    with open(vntrseek_output) as fh:
        lines = [ln.strip() for ln in fh if ln.strip()]
    for vntr_id, line in enumerate(lines):
        vntrseek_repeat, _, pattern, chromosome_number, start = line.split()
        if len(pattern) > 100 or len(pattern) < 6:
            continue
        start = int(start) - 1
        estimated_repeats = int(float(vntrseek_repeat) + 2)
        if chromosome is not None and chromosome_number != chromosome:
            continue
        if annotation_assigner is not None:
            end = estimated_repeats * len(pattern) + start
            if not annotation_assigner.is_close_to_gene(
                    chromosome_number, start, end):
                continue
        vntrs.append(ReferenceVNTR(vntr_id, pattern, start,
                                   chromosome_number, None, None,
                                   estimated_repeats,
                                   chromosome_sequence=chromosome_seq))
    return vntrs


def find_non_overlapping_vntrs(vntrs, max_region: int = 1000):
    """Decompose each locus and mark overlapping ones
    (reference semantics: models.py:46-66)."""
    skipped = set()
    for i in range(len(vntrs)):
        estimated_end = (len(vntrs[i].pattern) * vntrs[i].estimated_repeats
                         + vntrs[i].start_point)
        if i < len(vntrs) - 1 and \
                vntrs[i].chromosome == vntrs[i + 1].chromosome and \
                estimated_end > vntrs[i + 1].start_point:
            vntrs[i].estimated_repeats += vntrs[i + 1].estimated_repeats
        if len(vntrs[i].pattern) * vntrs[i].estimated_repeats > max_region:
            vntrs[i].non_overlapping = False
            continue
        try:
            vntrs[i].init_from_vntrseek_data()
        except Exception as error:
            logging.warning("decomposition failed for %s: %s",
                            vntrs[i].id, error)
            vntrs[i].non_overlapping = False
            continue
        if i in skipped:
            vntrs[i].non_overlapping = False
        else:
            j = i + 1
            end_point = (len(vntrs[i].pattern)
                         * len(vntrs[i].get_repeat_segments())
                         + vntrs[i].start_point)
            while j < len(vntrs) and \
                    vntrs[i].chromosome == vntrs[j].chromosome and \
                    end_point > vntrs[j].start_point:
                skipped.add(j)
                j += 1
    return vntrs


def build_database_from_vntrseek(vntrseek_output: str, chromosome_seq: str,
                                 db_file: str, chromosome: str | None = None,
                                 vntr_length_threshold: int = 10000) -> int:
    """Full pipeline: parse -> decompose -> screen -> persist.
    Returns the number of saved loci."""
    import os
    from advntr_tpu_torch.models.db import (create_vntrs_database,
                                      save_reference_vntr_to_database)
    vntrs = load_unprocessed_vntrseek_data(vntrseek_output, chromosome_seq,
                                           chromosome)
    vntrs = find_non_overlapping_vntrs(vntrs)
    if not os.path.exists(db_file):
        create_vntrs_database(db_file)
    saved = 0
    for vntr in vntrs:
        if not vntr.is_non_overlapping():
            continue
        if vntr.get_length() > vntr_length_threshold:
            continue
        save_reference_vntr_to_database(vntr, db_file)
        saved += 1
    return saved
