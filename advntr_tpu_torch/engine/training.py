"""Model training for ``addmodel``: the recruitment-score threshold.

Counterpart of advntr_tpu/engine/training.py (reference semantics
vntr_finder.py:901-1021): simulate reads from the locus and decoy reads
from keyword-sharing windows of the chromosome, Viterbi-score both sets
with the locus model on the device (B1 and B2, in chunks of 512 reads),
fit a logistic decision boundary on the scores, and store the scaled
threshold (score / read length) in the model DB.  The logistic fit is
sklearn's ``LogisticRegression()`` written out with scipy (the card's host
has no sklearn); everything else is the reference's.
"""

from __future__ import annotations

import logging
import os
import random

import numpy as np
from scipy import optimize, special

from advntr_tpu_torch import dna
from advntr_tpu_torch.config import Config, DEFAULT_CONFIG
from advntr_tpu_torch.engine.recruitment import keywords_for_locus
from advntr_tpu_torch.engine.simulate import simulate_true_reads


def rolling_kmer_codes(codes: np.ndarray, k: int) -> np.ndarray:
    """Exact 2-bit k-mer codes per position; -1 where the window has non-ACGT."""
    n = len(codes) - k + 1
    if n <= 0:
        return np.zeros(0, dtype=np.int64)
    out = np.zeros(n, dtype=np.int64)
    ok = np.ones(n, dtype=bool)
    c = codes.astype(np.int64)
    for j in range(k):
        win = c[j:j + n]
        out = out * 4 + np.where(win < 4, win, 0)
        ok &= win < 4
    out[~ok] = -1
    return out


def simulate_false_filtered_reads(ref_vntr, chromosome_seq: str,
                                  read_size: int = 150, keyword_size: int = 11,
                                  min_match: int = 3,
                                  max_false_reads: int = 10000) -> list[str]:
    """Decoy reads: windows of the chromosome sharing >= min_match 11-mers
    with the locus keywords within one read length, excluding the locus
    itself (reference semantics: vntr_finder.py:924-971)."""
    keywords = keywords_for_locus(ref_vntr, True, keyword_size)
    kw_codes = {c for c in
                (np.array([dna.encode(k) for k in keywords])
                 .astype(np.int64) @
                 (4 ** np.arange(keyword_size - 1, -1, -1, dtype=np.int64)))
                }
    seq = chromosome_seq.upper()
    codes = dna.encode(seq)
    pos_codes = rolling_kmer_codes(codes, keyword_size)
    kw_arr = np.fromiter(kw_codes, dtype=np.int64)
    hits = np.isin(pos_codes, kw_arr) & (pos_codes >= 0)
    vntr_start = ref_vntr.start_point
    vntr_end = vntr_start + ref_vntr.get_length()
    positions = np.nonzero(hits)[0]
    in_locus = (positions > vntr_start - read_size) & (positions < vntr_end)
    positions = positions[~in_locus]

    false_reads: list[str] = []
    match_positions: list[int] = []
    for i in positions:
        match_positions.append(int(i))
        if len(match_positions) >= min_match and \
                match_positions[-1] - match_positions[-min_match] < read_size:
            for j in range(match_positions[-1] - read_size,
                           match_positions[-min_match], 5):
                if j < 0:
                    continue
                window = seq[j:j + read_size]
                if "N" not in window and len(window) == read_size:
                    false_reads.append(window)
        if len(false_reads) > max_false_reads:
            break
    return false_reads


def _logistic_fit(x: np.ndarray, y: np.ndarray) -> tuple[float, float]:
    """(coefficient, intercept) of sklearn 1.9's ``LogisticRegression()``
    (C = 1, lbfgs, max_iter 100, tol 1e-4) on one feature, as its lbfgs
    branch fits it (sklearn/linear_model/_logistic.py:580-594 and
    _linear_loss.py:291-361): the mean half-binomial loss plus
    0.5 / (C n) w^2 (the intercept not penalised), from x0 = 0, by
    L-BFGS-B with maxls 50, gtol 1e-4 and ftol 64 eps."""
    n = len(y)
    l2 = 1.0 / n

    def loss_grad(coef):
        w, b = coef
        raw = w * x + b
        # log(1 + exp(raw)) - y raw, and its derivative expit(raw) - y
        loss = np.logaddexp(0.0, raw) - y * raw
        grad_point = (special.expit(raw) - y) / n
        value = loss.sum() / n + 0.5 * l2 * w * w
        grad = np.array([x @ grad_point + l2 * w, grad_point.sum()])
        return value, grad

    res = optimize.minimize(
        loss_grad, np.zeros(2), method="L-BFGS-B", jac=True,
        options={"maxiter": 100, "maxls": 50, "gtol": 1e-4,
                 "ftol": 64 * np.finfo(float).eps})
    return float(res.x[0]), float(res.x[1])


def find_recruitment_score_threshold(true_scores, false_scores):
    """Logistic decision boundary over Viterbi scores
    (reference semantics: vntr_finder.py:1006-1021): the first integer
    score from -1 down that the fit classes as a decoy (sklearn's
    ``predict`` gives class 0 where w i + b <= 0)."""
    if len(false_scores) == 0:
        false_scores = [min(true_scores) - 2]
    x = np.asarray(list(true_scores) + list(false_scores), dtype=np.float64)
    y = np.asarray([1] * len(true_scores) + [0] * len(false_scores),
                   dtype=np.float64)
    w, b = _logistic_fit(x, y)
    recruitment_score = max(true_scores)
    for i in range(-1, -300, -1):
        if not w * i + b > 0:
            recruitment_score = i
            break
    return recruitment_score


def train_classifier_threshold(ref_vntr, chromosome_seq: str,
                               read_length: int = 150,
                               config: Config = DEFAULT_CONFIG,
                               device="cuda") -> float:
    """Scaled recruitment threshold for one locus, its reads scored on
    ``device`` (reference semantics: vntr_finder.py:901-911)."""
    from advntr_tpu_torch.engine.finder import VNTRFinder
    finder = VNTRFinder(ref_vntr, config, device=device)
    true_reads = simulate_true_reads(ref_vntr, read_length,
                                     random.Random(0))
    false_reads = simulate_false_filtered_reads(ref_vntr, chromosome_seq,
                                                read_size=read_length)
    logging.info("training threshold: %d true, %d decoy reads",
                 len(true_reads), len(false_reads))

    def scores(reads):
        out = []
        chunk = 512
        for i in range(0, len(reads), chunk):
            scored, _ = finder.score_reads(
                [], [(str(j), r) for j, r in enumerate(reads[i:i + chunk])],
                read_length)
            out.extend(r.logp for r in scored if np.isfinite(r.logp)
                       and r.repeat_bp > finder.min_repeat_bp_to_add_read
                       and finder.recruit_read(r, -10000))
        return out

    true_scores = scores(true_reads)
    false_scores = scores(false_reads)
    if not true_scores:
        return 0.0
    threshold = find_recruitment_score_threshold(true_scores, false_scores)
    return threshold / float(read_length)


def train_and_add_model(reference_file: str, chromosome: str, pattern: str,
                        start: int, end: int, gene=None, annotation=None,
                        db_file: str = "vntr_data/models.db",
                        config: Config = DEFAULT_CONFIG,
                        device="cuda") -> int:
    """Full addmodel flow (reference: advntr_commands.py:179-215), the
    threshold's reads scored on ``device``."""
    from advntr_tpu_torch.io.fasta import load_chromosome
    from advntr_tpu_torch.models.db import (create_vntrs_database,
                                            get_largest_id_in_database,
                                            save_reference_vntr_to_database)
    from advntr_tpu_torch.models.reference_vntr import ReferenceVNTR

    chr_sequence = load_chromosome(reference_file, chromosome)
    if not chr_sequence:
        raise ValueError(f"chromosome {chromosome} not found in "
                         f"{reference_file}")
    if not os.path.exists(db_file):
        create_vntrs_database(db_file)
    vntr_id = get_largest_id_in_database(db_file) + 1
    estimated_repeats = int((end - start) / len(pattern) + 5)
    ref_vntr = ReferenceVNTR(vntr_id, pattern, start, chromosome, gene,
                             annotation, estimated_repeats, chr_sequence)
    ref_vntr.init_from_vntrseek_data()
    ref_vntr.scaled_score = train_classifier_threshold(
        ref_vntr, chr_sequence, config=config, device=device)
    save_reference_vntr_to_database(ref_vntr, db_file)
    return vntr_id
