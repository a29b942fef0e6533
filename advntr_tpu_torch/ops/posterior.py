"""Backward, forward-backward and the frameshift posterior over compiled
HMMs, in plain PyTorch on the device of their inputs.

Counterpart of advntr_tpu/ops/posterior.py, which runs these as XLA
scans (not Pallas): on the silent-eliminated sum-semiring model
(``compile_graph_sum``), one forward sweep keeps the alpha planes and one
reversed sweep computes beta while it sums per-read posterior statistics,
so the posterior returns O(B) numbers.  Each column forms one (B, n, n)
term per sweep; the log-sum-exp overwrites it in place (the reference's
expression, one temporary alive at a time).

Deletions are silent, so their posterior evidence lives in the
effective-transition closures: each effective weight splits as

    exp(log_T[i, j]) = exp(log_T_nodel[i, j]) + exp(log_T_del[i, j])

where ``log_T_nodel`` closes the silent subgraph without the repeat
delete states and ``log_T_del`` (``log_sub`` of the two closures) is the
weight of the routes through at least one repeat delete.  Their expected
use is an ordinary expected transition count against ``log_T_del``: the
derivative of the log-likelihood under a tilt of those routes.
"""

from __future__ import annotations

import numpy as np
import torch

from advntr_tpu_torch.models.compiler import compile_graph_sum
from advntr_tpu_torch.models.graph import K_DELETE, K_INSERT, R_REPEAT
from advntr_tpu_torch.ops.viterbi import NEG32, lse_, emissions, lse_sum


def clean_neg(x, device, dtype=torch.float32):
    """Replace -inf with the f32-safe floor and upload to ``device``."""
    x = np.asarray(x, dtype=np.float64)
    x = np.where(np.isfinite(x), x, np.float64(NEG32))
    return torch.as_tensor(x, dtype=dtype, device=device)


def log_sub(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Elementwise log(exp(a) - exp(b)) for b <= a (host, float64).
    Entries where b catches up to a (no extra mass) map to -1e30."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        d = b - a
        out = a + np.log1p(-np.exp(np.minimum(d, -1e-12)))
    bad = ~np.isfinite(a) | (d > -1e-9)
    out = np.where(bad, np.float64(NEG32), out)
    return out


def indel_model(graph):
    """The posterior's host tables of a read-matcher graph: the
    sum-closed (log_T, log_E, log_start, log_end), the parts of log_T,
    log_start and log_end routed through at least one repeat delete, and
    the repeat insert mask (n,) float32 (finder.py:1053-1088)."""
    full = compile_graph_sum(graph)
    nodel = compile_graph_sum(
        graph, drop_silent=lambda s: s.kind == K_DELETE
        and s.region == R_REPEAT)
    emitting = [s for i, s in enumerate(graph.states)
                if not s.is_silent and i not in (graph.start, graph.end)]
    occ_mask = np.array([s.kind == K_INSERT and s.region == R_REPEAT
                         for s in emitting], dtype=np.float32)
    return tuple(full) + (log_sub(full[0], nodel[0]),
                          log_sub(full[2], nodel[2]),
                          log_sub(full[3], nodel[3])), occ_mask


def forward_planes(log_T, log_start, emis, lengths):
    """alpha planes (L, B, n), each read frozen past its last column."""
    L = emis.shape[0]
    planes = [log_start[None, :] + emis[0]]
    for t in range(1, L):
        v = planes[-1]
        nv = lse_sum(v[:, :, None], log_T[None, :, :], 1) + emis[t]
        planes.append(torch.where((t < lengths)[:, None], nv, v))
    return torch.stack(planes)


def beta_step(log_T, log_end, e_next, beta_next, t, lengths):
    """beta at column t from column t+1, re-seeded with log_end at each
    read's own last column."""
    rec = lse_sum((e_next + beta_next)[:, None, :], log_T[None, :, :], 2)
    return torch.where((t == lengths - 1)[:, None], log_end[None, :], rec)


def last_beta(log_end, lengths, L):
    """beta at column L-1: log_end where a read fills the row, else the
    floor."""
    return torch.where((lengths == L)[:, None], log_end[None, :],
                       torch.tensor(NEG32, dtype=log_end.dtype,
                                    device=log_end.device))


def backward_batch(log_T, log_E, log_start, log_end, seqs, lengths):
    """Per-read log-likelihood from the backward recursion alone
    (posterior.py:65), the partner of ``viterbi.forward_batch``.
    Returns loglik (B,)."""
    B, L = seqs.shape
    lengths = lengths.long()
    emis = emissions(log_E, seqs)
    beta = last_beta(log_end, lengths, L)
    for t in range(L - 2, -1, -1):
        beta = beta_step(log_T, log_end, emis[t + 1], beta, t, lengths)
    return lse_(log_start[None, :] + emis[0] + beta, 1)


def forward_backward_batch(log_T, log_E, log_start, log_end, seqs,
                           lengths):
    """Per-position state posteriors (posterior.py:94): (loglik (B,),
    gamma (L, B, n)) with gamma[t, b, j] = log P(state j at t | read b);
    columns at or past a read's length hold garbage."""
    B, L = seqs.shape
    lengths = lengths.long()
    emis = emissions(log_E, seqs)
    alphas = forward_planes(log_T, log_start, emis, lengths)
    loglik = lse_(alphas[-1] + log_end[None, :], 1)
    betas = [last_beta(log_end, lengths, L)]
    for t in range(L - 2, -1, -1):
        betas.append(beta_step(log_T, log_end, emis[t + 1], betas[-1], t,
                               lengths))
    betas = torch.stack(betas[::-1])
    return loglik, alphas + betas - loglik[None, :, None]


def posterior_indel_batch(log_T, log_E, log_start, log_end,
                          log_T_del, log_start_del, log_end_del,
                          occ_mask, seqs, lengths):
    """The frameshift posterior (posterior.py:137): per-read expected
    emissions from the ``occ_mask`` states (repeat inserts) and expected
    transitions routed through at least one repeat delete.

    Args: the sum-closed tables (-inf cleaned, ``clean_neg``), their
    delete-routed parts (``log_sub`` of the full and delete-free
    closures), occ_mask (n,) 0/1, seqs (B, L) codes, lengths (B,).
    Returns a dict of (B,) tensors: loglik, loglik_backward,
    ins_occupancy, del_mass."""
    B, L = seqs.shape
    lengths = lengths.long()
    emis = emissions(log_E, seqs)
    occ_maskf = occ_mask.to(log_T.dtype)

    alphas = forward_planes(log_T, log_start, emis, lengths)
    aF = alphas[-1]
    loglik = lse_(aF + log_end[None, :], 1)
    # i -> END closure deletes (aF is frozen at each read's last column)
    end_del = torch.exp(lse_(aF + log_end_del[None, :], 1) - loglik)

    beta = last_beta(log_end, lengths, L)
    occ = torch.where(
        lengths == L,
        torch.sum(torch.exp(aF + beta - loglik[:, None])
                  * occ_maskf[None, :], 1),
        torch.zeros((), dtype=log_T.dtype, device=log_T.device))
    dmass = torch.zeros(B, dtype=log_T.dtype, device=log_T.device)
    for t in range(L - 2, -1, -1):
        alpha_t, e_next = alphas[t], emis[t + 1]
        # expected delete-routed transitions into column t+1
        m = lse_sum(alpha_t[:, :, None], log_T_del[None, :, :], 1)
        d = torch.sum(torch.exp(m + e_next + beta - loglik[:, None]), 1)
        dmass = dmass + torch.where(t + 1 < lengths, d, 0.0)
        beta = beta_step(log_T, log_end, e_next, beta, t, lengths)
        # masked posterior occupancy at column t
        g = torch.exp(alpha_t + beta - loglik[:, None])
        occ = occ + torch.where(t < lengths,
                                torch.sum(g * occ_maskf[None, :], 1), 0.0)

    loglik_b = lse_(log_start[None, :] + emis[0] + beta, 1)
    start_del = torch.exp(
        lse_(log_start_del[None, :] + emis[0] + beta, 1) - loglik)
    return {
        "loglik": loglik,
        "loglik_backward": loglik_b,
        "ins_occupancy": occ,
        "del_mass": dmass + start_del + end_del,
    }
