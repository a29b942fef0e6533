"""Maximum-likelihood diploid genotype model over observed RU counts.

Reference semantics: vntr_finder.py:473-532 (conditional likelihood with
mutation rate r=0.03, pair posterior over observed count pairs) and
vntr_finder.py:256-263 (binomial likelihood-ratio frameshift test).
These are tiny host-side computations; the heavy per-read work happens on
device before counts reach this module.
"""

from __future__ import annotations

import numpy as np
from scipy.stats import binom


def _conditional_likelihood(ck: int, ci: int, cj: int, r: float,
                            r_e: float) -> float:
    if ck == ci == cj:
        return 1 - r
    if cj == 0:
        return 0.5 * (1 - r)
    if ck == ci:
        return 0.5 * ((1 - r) + r_e ** abs(ck - cj))
    if ck == cj:
        return 0.5 * ((1 - r) + r_e ** abs(ck - ci))
    return 0.5 * (r_e ** abs(ck - ci) + r_e ** abs(ck - cj))


def find_genotype(observed_copy_numbers, is_haploid: bool = False,
                  r: float = 0.03):
    """Best (ci, cj) pair and its posterior over observed RU counts."""
    ru_counts: dict[int, int] = {}
    for cn in observed_copy_numbers:
        ru_counts[cn] = ru_counts.get(cn, 0) + 1
    if len(ru_counts) < 2:
        priors = 0.5
        ru_counts[0] = 1
    else:
        k = len(ru_counts)
        priors = 1.0 / (k * (k - 1) / 2)
    items = sorted(ru_counts.items(), key=lambda kv: kv[1], reverse=True)
    r_e = r / (2 + r)

    prs: dict[tuple[int, int], list[float]] = {}
    for ck, occ in items:
        if ck == 0:
            continue
        for i in range(len(items)):
            ci = items[i][0]
            for j in range(len(items)):
                if j < i:
                    continue
                if is_haploid and i != j:
                    continue
                cj = items[j][0]
                prs.setdefault((ci, cj), []).append(
                    _conditional_likelihood(ck, ci, cj, r, r_e) ** occ)

    posteriors = {key: float(np.prod(np.array(vals))) * priors
                  for key, vals in prs.items()}
    total = sum(posteriors.values())
    max_prob = 1e-20
    result = None
    for key, value in posteriors.items():
        if total and value / total > max_prob:
            max_prob = value / total
            result = key
    return result, max_prob


def identify_frameshift(location_coverage: float,
                        observed_indel_transitions: int,
                        expected_indels: float,
                        error_rate: float = 0.01) -> bool:
    """Call a frameshift when the indel count is implausible under the
    sequencing-error model relative to a heterozygous-indel model."""
    if observed_indel_transitions >= location_coverage:
        return True
    sequencing_error_prob = binom.pmf(observed_indel_transitions,
                                      location_coverage, error_rate)
    frameshift_prob = binom.pmf(observed_indel_transitions,
                                location_coverage, expected_indels)
    prob = sequencing_error_prob / frameshift_prob
    return bool(prob < 0.01)
