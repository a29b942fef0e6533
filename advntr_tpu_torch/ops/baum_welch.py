"""Batched Baum-Welch (EM) statistics and re-estimation on compiled HMMs.

Counterpart of advntr_tpu/ops/baum_welch.py.  The silent-eliminated
sum-semiring model (``compile_graph_sum``) is an ordinary first-order HMM
over emitting states, so the textbook forward-backward expected counts
are exact on it.  ``baum_welch_stats`` runs on the device of its inputs
in plain PyTorch (the reference runs it as XLA scans, not Pallas): one
forward sweep keeps the alpha planes, one reversed sweep sums

    xi[i, j]   += E[# transitions i -> j]
    emit[i, s] += E[# emissions of symbol s from i]

over the batch inside the sweep, so the output is O(n^2).  A column's xi
term is one float32 product exp(alpha_t)^T x exp(e + beta), with TF32
off, times exp(log_T).  Every count is flushed to zero where it falls
under float32's smallest normal number, as XLA flushes subnormals
(``ops/viterbi.flush_``): the M-step keeps a state's old row where its
mass is zero, so a subnormal count would change the model.  One case
stays apart: a column's xi product sums its reads' terms before the
flush, where XLA drops each term under that number, so a transition
that only such terms reach re-estimates to about 1e-39 instead of
the floor; the finder folds back only the emissions.  The M-step
(``baum_welch_update``) is host numpy in float64, verbatim.
"""

from __future__ import annotations

import numpy as np
import torch

from advntr_tpu_torch.device import full_float32_matmul
from advntr_tpu_torch.ops.posterior import (beta_step, clean_neg,
                                            forward_planes, last_beta)
from advntr_tpu_torch.ops.viterbi import (NEG32, emissions, exp_ftz,
                                          flush_, lse_)


def baum_welch_stats(log_T, log_E, log_start, log_end, seqs, lengths):
    """Expected-count (summarize) pass of Baum-Welch over a read batch
    (baum_welch.py:42).

    Args: sum-closed model tensors (-inf cleaned, ``clean_neg``), seqs
    (B, L) codes, lengths (B,), all on one device.

    Returns dict: loglik (B,), xi (n, n), emit (n, 4), gamma_start (n,),
    gamma_end (n,), the counts summed over reads."""
    B, L = seqs.shape
    n = log_T.shape[0]
    lengths = lengths.long()
    emis = emissions(log_E, seqs)
    onehot = torch.nn.functional.one_hot(
        seqs.long().clamp(0, 3), 4).to(log_T.dtype)          # (B, L, 4)

    alphas = forward_planes(log_T, log_start, emis, lengths)
    aF = alphas[-1]
    loglik = lse_(aF + log_end[None, :], 1)
    gamma_end = torch.sum(exp_ftz(aF + log_end[None, :]
                                  - loglik[:, None]), 0)

    with full_float32_matmul():
        beta = last_beta(log_end, lengths, L)
        emit = torch.where((lengths == L)[:, None],
                           exp_ftz(aF + beta - loglik[:, None]),
                           0.0).T @ onehot[:, L - 1]
        expT = torch.exp(log_T)
        xi = torch.zeros((n, n), dtype=log_T.dtype, device=log_T.device)
        for t in range(L - 2, -1, -1):
            alpha_t, e_next = alphas[t], emis[t + 1]
            # xi_t[i, j] = sum_b exp(a_t[b,i] - ll[b]) T[i,j] exp(e+beta)[b,j]
            live = ((t + 1) < lengths)[:, None]
            fa = exp_ftz(alpha_t - loglik[:, None]) * live
            fb = exp_ftz(e_next + beta)
            fb = torch.where(live, fb, 0.0)
            xi = xi + flush_(expT * flush_(fa.T @ fb))
            beta = beta_step(log_T, log_end, e_next, beta, t, lengths)
            # emission counts at column t: gamma_t^T x onehot_t
            g = exp_ftz(alpha_t + beta - loglik[:, None])
            g = torch.where((t < lengths)[:, None], g, 0.0)
            emit = emit + g.T @ onehot[:, t]

    gamma_start = torch.sum(
        exp_ftz(log_start[None, :] + emis[0] + beta - loglik[:, None]), 0)
    return {"loglik": loglik, "xi": xi, "emit": emit,
            "gamma_start": gamma_start, "gamma_end": gamma_end}


def baum_welch_update(log_T, log_E, log_start, log_end, stats,
                      pseudocount: float = 0.0,
                      inertia: float = 0.0):
    """One M-step: normalized expected counts become the new parameters.

    Structural zeros are preserved (a transition/emission at the -1e30
    floor stays there regardless of counts — EM cannot create edges, only
    reweight them, matching pomegranate's from_summaries semantics).
    ``inertia`` linearly mixes old and new probabilities in probability
    space (reference hmm.pyx fit(inertia=...)).  Host-side numpy (f64):
    model re-estimation is offline, exactness beats speed here.
    """
    log_T = np.asarray(log_T, dtype=np.float64)
    log_E = np.asarray(log_E, dtype=np.float64)
    log_start = np.asarray(log_start, dtype=np.float64)
    log_end = np.asarray(log_end, dtype=np.float64)
    floor = np.float64(NEG32) / 2

    xi = np.asarray(stats["xi"], dtype=np.float64) + pseudocount
    emit = np.asarray(stats["emit"], dtype=np.float64) + pseudocount
    g0 = np.asarray(stats["gamma_start"], dtype=np.float64) + pseudocount
    gE = np.asarray(stats["gamma_end"], dtype=np.float64) + pseudocount

    t_mask = log_T > floor
    e_mask = log_E > floor
    s_mask = log_start > floor
    end_mask = log_end > floor

    xi = np.where(t_mask, xi, 0.0)
    emit = np.where(e_mask, emit, 0.0)
    g0 = np.where(s_mask, g0, 0.0)
    gE = np.where(end_mask, gE, 0.0)

    # per-state out-mass includes the end transition
    denom = xi.sum(axis=1) + gE
    with np.errstate(divide="ignore", invalid="ignore"):
        newT = np.where(t_mask & (denom[:, None] > 0),
                        xi / np.maximum(denom[:, None], 1e-300),
                        np.exp(np.where(t_mask, log_T, -np.inf)))
        newEnd = np.where(end_mask & (denom > 0),
                          gE / np.maximum(denom, 1e-300),
                          np.exp(np.where(end_mask, log_end, -np.inf)))
        e_denom = emit.sum(axis=1)
        newE = np.where(e_mask & (e_denom[:, None] > 0),
                        emit / np.maximum(e_denom[:, None], 1e-300),
                        np.exp(np.where(e_mask, log_E, -np.inf)))
        s_denom = g0.sum()
        newS = np.where(s_mask & (s_denom > 0),
                        g0 / max(s_denom, 1e-300),
                        np.exp(np.where(s_mask, log_start, -np.inf)))

    if inertia > 0.0:
        mix = lambda new, old_log, mask: np.where(
            mask, (1 - inertia) * new + inertia * np.exp(old_log), new)
        newT = mix(newT, log_T, t_mask)
        newE = mix(newE, log_E, e_mask)
        newS = mix(newS, log_start, s_mask)
        newEnd = mix(newEnd, log_end, end_mask)

    def relog(p, mask):
        out = np.full(p.shape, np.float64(NEG32))
        np.log(np.maximum(p, 1e-300), out=out, where=mask)
        return out

    return (relog(newT, t_mask), relog(newE, e_mask),
            relog(newS, s_mask), relog(newEnd, end_mask))


def baum_welch_fit(log_T, log_E, log_start, log_end, seqs, lengths,
                   max_iters: int = 10, stop_threshold: float = 1e-3,
                   pseudocount: float = 0.0, inertia: float = 0.0):
    """The EM loop (baum_welch.py:187): statistics on the device of
    ``seqs``, the M-step on the host, until the total log-likelihood
    improves by less than ``stop_threshold``.

    Returns (params tuple of float64 numpy tables, history list of total
    logliks)."""
    params = (np.asarray(log_T, np.float64), np.asarray(log_E, np.float64),
              np.asarray(log_start, np.float64),
              np.asarray(log_end, np.float64))
    history = []
    for _ in range(max_iters):
        # the statistics run in float32; the stop test is the reference's
        # numpy sum of the per-read float32 logliks
        dev = tuple(clean_neg(p, seqs.device) for p in params)
        stats = baum_welch_stats(*dev, seqs, lengths)
        total = float(np.sum(stats["loglik"].cpu().numpy()))
        if history and total - history[-1] < stop_threshold:
            history.append(total)
            break
        history.append(total)
        stats = {k: v.cpu().numpy() for k, v in stats.items()}
        params = baum_welch_update(*params, stats,
                                   pseudocount=pseudocount, inertia=inertia)
    return params, history
