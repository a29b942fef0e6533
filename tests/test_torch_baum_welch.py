"""The port's Baum-Welch (ops/baum_welch.py) on the CPU, after
tests/test_baum_welch.py :55, :95, :114 and :178, and against the JAX
functions on the same seeded reads.

Tolerances: the statistics against the float64 oracle as the reference's
test states them (rtol 2e-3 / atol 1e-3); against JAX's statistics,
loglik rtol 1e-5 and the counts rtol 1e-4 / atol 1e-5 (float32 sums in
another order); ``baum_welch_fit``'s history within rtol 1e-6 of JAX's,
with the same number of iterations."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advntr_tpu.ops import baum_welch as jbw
from advntr_tpu.ops import posterior as jposterior
from advntr_tpu_torch import dna
from advntr_tpu_torch.config import Config
from advntr_tpu_torch.engine import analytics as an
from advntr_tpu_torch.engine.finder import LocusModelCache, VNTRFinder
from advntr_tpu_torch.engine.simulate import simulate_diploid_reads
from advntr_tpu_torch.models.compiler import compile_graph_sum
from advntr_tpu_torch.models.graph import build_read_matcher
from advntr_tpu_torch.models.msa import msa_from_viterbi_paths
from advntr_tpu_torch.models.profile import (profile_for_repeats,
                                             profile_from_alignment)
from advntr_tpu_torch.models.reference_vntr import ReferenceVNTR
from advntr_tpu_torch.ops.baum_welch import (baum_welch_fit,
                                             baum_welch_stats,
                                             baum_welch_update)
from advntr_tpu_torch.ops.posterior import clean_neg

# the suite runs test files in parallel worker processes: one torch thread
# each keeps them from oversubscribing the cores
torch.set_num_threads(1)

CPU = torch.device("cpu")
STATS = ("loglik", "xi", "emit", "gamma_start", "gamma_end")


def _tiny_model(pattern="ACGT", copies=2, flank=6, seed=3):
    rng = random.Random(seed)
    left = "".join(rng.choice("ACGT") for _ in range(flank))
    right = "".join(rng.choice("ACGT") for _ in range(flank))
    trans, emis = profile_for_repeats([pattern] * 3, 0.05)
    g = build_read_matcher(left, right, trans, emis, copies, 0.05)
    return g, left, right


def _oracle_counts(log_T, log_E, log_start, log_end, seq):
    """Explicit f64 forward-backward expected counts for ONE read."""
    n = log_T.shape[0]
    L = len(seq)
    T, E = np.exp(log_T), np.exp(log_E)
    s0, e0 = np.exp(log_start), np.exp(log_end)
    alpha = np.zeros((L, n))
    alpha[0] = s0 * E[:, seq[0]]
    for t in range(1, L):
        alpha[t] = (alpha[t - 1] @ T) * E[:, seq[t]]
    lik = float(alpha[-1] @ e0)
    beta = np.zeros((L, n))
    beta[-1] = e0
    for t in range(L - 2, -1, -1):
        beta[t] = T @ (E[:, seq[t + 1]] * beta[t + 1])
    xi = np.zeros((n, n))
    for t in range(L - 1):
        xi += np.outer(alpha[t], E[:, seq[t + 1]] * beta[t + 1]) * T / lik
    gamma = alpha * beta / lik
    emit = np.zeros((n, 4))
    for t in range(L):
        emit[:, seq[t]] += gamma[t]
    return np.log(lik), xi, emit, gamma[0], alpha[-1] * e0 / lik


def _noisy_reads(left, right, unit, copies, n, rate, seed):
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        s = left + unit * rng.choice(copies) + right
        out.append(dna.encode("".join(
            c if rng.random() > rate else rng.choice("ACGT") for c in s)))
    return out


def test_stats_match_f64_oracle_and_jax():
    g, left, right = _tiny_model()
    tables = compile_graph_sum(g)
    reads = _noisy_reads(left, right, "ACGT", [2], 4, 0.05, seed=11)
    batch, lengths = dna.pad_batch(reads, multiple=8)
    stats = baum_welch_stats(*(clean_neg(p, CPU) for p in tables),
                             torch.as_tensor(batch), torch.as_tensor(lengths))
    stats = {k: v.numpy() for k, v in stats.items()}

    oracle = [np.zeros_like(tables[0]), np.zeros((tables[0].shape[0], 4)),
              np.zeros(tables[0].shape[0]), np.zeros(tables[0].shape[0])]
    logliks = []
    for codes in reads:
        ll, *counts = _oracle_counts(*tables, list(codes))
        logliks.append(ll)
        for acc, c in zip(oracle, counts):
            acc += c
    np.testing.assert_allclose(stats["loglik"], logliks, rtol=1e-4,
                               atol=1e-3)
    for key, want in zip(STATS[1:], oracle):
        np.testing.assert_allclose(stats[key], want, rtol=2e-3, atol=1e-3,
                                   err_msg=key)

    ref = jbw.baum_welch_stats(*(jposterior.clean_neg(p) for p in tables),
                               jnp.asarray(batch), jnp.asarray(lengths))
    np.testing.assert_allclose(stats["loglik"], np.asarray(ref["loglik"]),
                               rtol=1e-5)
    for key in STATS[1:]:
        np.testing.assert_allclose(stats[key], np.asarray(ref[key]),
                                   rtol=1e-4, atol=1e-5, err_msg=key)


def test_update_equals_reference():
    g, left, right = _tiny_model(pattern="ACGTTG", copies=3, flank=10)
    tables = compile_graph_sum(g)
    reads = _noisy_reads(left, right, "ACGTTG", [2, 3], 8, 0.08, seed=5)
    batch, lengths = dna.pad_batch(reads, multiple=8)
    stats = baum_welch_stats(*(clean_neg(p, CPU) for p in tables),
                             torch.as_tensor(batch), torch.as_tensor(lengths))
    stats = {k: v.numpy() for k, v in stats.items()}
    for inertia in (0.0, 0.3):
        got = baum_welch_update(*tables, stats, pseudocount=0.1,
                                inertia=inertia)
        want = jbw.baum_welch_update(*tables, stats, pseudocount=0.1,
                                     inertia=inertia)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def _fit_inputs():
    g, left, right = _tiny_model(pattern="ACGTTG", copies=3, flank=10)
    reads = _noisy_reads(left, right, "ACGTTG", [2, 3], 12, 0.08, seed=5)
    batch, lengths = dna.pad_batch(reads, multiple=8)
    return compile_graph_sum(g), batch, lengths


def test_em_monotone_loglik():
    tables, batch, lengths = _fit_inputs()
    _, history = baum_welch_fit(*tables, torch.as_tensor(batch),
                                torch.as_tensor(lengths), max_iters=6)
    assert len(history) >= 2
    for a, b in zip(history, history[1:]):
        assert b >= a - 1e-2, history   # f32 slack only


@pytest.mark.parametrize("max_iters,inertia", [(6, 0.0), (10, 0.2)])
def test_fit_history_equals_jax(max_iters, inertia):
    tables, batch, lengths = _fit_inputs()
    params, history = baum_welch_fit(
        *tables, torch.as_tensor(batch), torch.as_tensor(lengths),
        max_iters=max_iters, inertia=inertia)
    jparams, jhistory = jbw.baum_welch_fit(
        *tables, jnp.asarray(batch), jnp.asarray(lengths),
        max_iters=max_iters, inertia=inertia)
    assert len(history) == len(jhistory) >= 2
    np.testing.assert_allclose(history, jhistory, rtol=1e-6)
    # the tables after the same number of M-steps from float32 counts, as
    # probabilities: a log of a count near 0 moves with its last bits
    for a, b in zip(params, jparams):
        np.testing.assert_allclose(np.exp(a), np.exp(b), rtol=1e-3,
                                   atol=1e-5)


def test_em_update_tracks_viterbi_update_direction():
    """A systematic substitution inside the repeat pulls the repeat
    match-state emission toward the substituted base under both update
    mechanisms (EM here, the Viterbi-path --update by recounting the
    decoded paths)."""
    pattern = "GATCGATTCGAA"
    mutated = "GATCGATTCGTA"   # A->T at position 10
    rng = random.Random(31)
    ref = ReferenceVNTR(90, pattern, 1000, "chr1")
    ref.repeat_segments = [pattern] * 3
    ref.left_flanking_region = "".join(rng.choice("ACGT")
                                       for _ in range(200))
    ref.right_flanking_region = "".join(rng.choice("ACGT")
                                        for _ in range(200))
    read_length = 100
    finder = VNTRFinder(ref, Config(),
                        model_cache=LocusModelCache(device="cpu"))
    hap = (ref.left_flanking_region[-40:] + mutated * 3 +
           ref.right_flanking_region[:40])
    reads = []
    for _ in range(10):
        start = rng.randint(0, max(0, len(hap) - read_length))
        reads.append(hap[start:start + read_length])

    out = finder.em_update(reads, read_length, max_iters=3)
    idxs = [i for i, nm in enumerate(out["names"]) if nm.startswith("M11_")]
    assert idxs
    E1 = np.exp(np.asarray(out["log_E"]))
    t_mass = float(np.mean(E1[idxs, dna.encode("T")[0]]))
    a_mass = float(np.mean(E1[idxs, dna.encode("A")[0]]))
    assert t_mass > a_mass, (t_mass, a_mass)
    assert out["history"][-1] >= out["history"][0]

    scored, stats = finder.score_reads(
        [(f"r{i}", s) for i, s in enumerate(reads)], [], read_length,
        return_paths=True)
    lm = finder.get_model(read_length)
    reps, vps = [], []
    for read in scored:
        visited = lm.visited_states(stats["path"][read.row]
                                    [:len(read.sequence)])
        r, v = an.extract_repeating_segments(read.sequence, visited)
        reps += r
        vps += v
    trans, emis = profile_from_alignment(0.05,
                                         msa_from_viterbi_paths(reps, vps))
    assert emis["M11"].get("T", 0.0) > emis["M11"].get("A", 0.0)


def test_em_update_genotype_stability_vs_viterbi_update():
    """On a clean locus the EM-updated model, the Viterbi-path-updated
    model and the unchanged model genotype alike (test_baum_welch.py:178)."""
    rng = random.Random(17)
    pattern = "CGCGGGGCGGGG"
    left = "".join(rng.choice("ACGT") for _ in range(120))
    right = "".join(rng.choice("ACGT") for _ in range(120))
    ref = ReferenceVNTR(12, pattern, 1000, "chr1")
    ref.repeat_segments = [pattern] * 3
    ref.left_flanking_region = left
    ref.right_flanking_region = right
    reads, _, _ = simulate_diploid_reads(left, pattern, 2, 3, right,
                                         read_length=60, coverage=25,
                                         error_rate=0.002, seed=6)
    finder = VNTRFinder(ref, Config(),
                        model_cache=LocusModelCache(device="cpu"))
    plain = finder.find_repeat_count([], reads, read_length=60)
    vit = finder.find_repeat_count([], reads, read_length=60, update=True)
    em = finder.find_repeat_count([], reads, read_length=60, update=True,
                                  em=True)
    assert sorted(plain.copy_numbers) == [2, 3]
    assert sorted(vit.copy_numbers) == sorted(plain.copy_numbers)
    assert sorted(em.copy_numbers) == sorted(plain.copy_numbers)
