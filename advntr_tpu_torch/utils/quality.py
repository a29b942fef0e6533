"""Read quality gates (reference semantics: advntr/utils.py:20-38)."""

from __future__ import annotations

import logging


def is_low_quality_read(mapq: int, qualities, mapq_cutoff: int = 0,
                        quality_score_cutoff: int = 20,
                        low_quality_fraction: float = 0.10) -> bool:
    if mapq <= mapq_cutoff:
        logging.debug("Rejecting read for poor mapping quality")
        return True
    if not qualities:
        return False
    low = [i for i, q in enumerate(qualities) if q < quality_score_cutoff]
    if len(low) >= low_quality_fraction * len(qualities):
        logging.debug("Rejecting read for many low quality base pairs")
        return True
    low_set = set(low)
    max_run = int(low_quality_fraction * len(qualities) / 4)
    for i in low:
        passed = False
        for j in range(i + 1, i + max_run):
            if j not in low_set:
                passed = True
                break
        if not passed:
            logging.debug("Rejecting read for long run of low quality bps")
            return True
    return False
