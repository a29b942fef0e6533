"""Viterbi and forward over compiled (silent-free) HMMs, dense.

Counterpart of advntr_tpu/ops/viterbi.py:

- ``viterbi_numpy``: the float64 single-read decoder that the repeat
  finder of ``models/reference_vntr.py`` runs on the host (verbatim);
- ``viterbi_batch`` and ``forward_batch``: batched max-plus and
  log-sum-exp dynamic programming over dense (n, n) tables in plain
  PyTorch, on the device of their inputs.  The reference's ``lax.scan``
  over columns is a Python loop here, with the same freezes past each
  read's length.  The reference runs them as XLA, not Pallas, so there is
  no hand-written kernel to hold them to; the decoders of the genotype
  path are the structured kernels of ``ops/viterbi_fused.py``.
"""

from __future__ import annotations

import numpy as np
import torch

NEG32 = np.float32(-1e30)


def viterbi_numpy(art, codes: np.ndarray):
    """Single-read float64 Viterbi over a compiled artifact.

    Returns (logp, path) where path is the emitting-state index sequence.
    """
    log_T, log_E = art.log_T, art.log_E
    n = art.n_states
    L = len(codes)
    v = art.log_start + log_E[:, codes[0]]
    args = np.zeros((L, n), dtype=np.int32)
    for t in range(1, L):
        scores = v[:, None] + log_T
        args[t] = np.argmax(scores, axis=0)
        v = scores[args[t], np.arange(n)] + log_E[:, codes[t]]
    final = v + art.log_end
    end_state = int(np.argmax(final))
    logp = final[end_state]
    if not np.isfinite(logp):
        return float(logp), None
    path = np.zeros(L, dtype=np.int32)
    cur = end_state
    for t in range(L - 1, -1, -1):
        path[t] = cur
        if t > 0:
            cur = args[t][cur]
    return float(logp), path


def emissions(log_E: torch.Tensor, seqs: torch.Tensor) -> torch.Tensor:
    """(L, B, n) emission log-probabilities of a (B, L) code batch: the
    reference's ``jnp.take(log_E, seqs.T, axis=1)`` transposed to
    (L, B, n), indexed with int64 codes."""
    return log_E.T[seqs.T.long()]


def viterbi_batch(log_T, log_E, log_start, log_end, seqs, lengths,
                  return_path: bool = True):
    """Batched Viterbi (viterbi.py:59): one max over (B, n, n) a column,
    the value planes kept; the traceback re-derives each argmax on the one
    visited state a column (the first maximum wins, as ``jnp.argmax``).

    Args: (n, n), (n, 4), (n,), (n,) float tables (-inf cleaned to NEG32,
    ``prepare_model_tensors``); seqs (B, L) codes in [0, 4); lengths (B,).
    Returns (logp (B,), end_state (B,), path (B, L) or None); past a
    read's length its path repeats a state that callers ignore."""
    B, L = seqs.shape
    lengths = lengths.long()
    emis = emissions(log_E, seqs)
    v = log_start[None, :] + emis[0]
    best = torch.amax(v + log_end[None, :], dim=1)
    planes = []
    for t in range(1, L):
        planes.append(v)
        new_v = torch.amax(v[:, :, None] + log_T[None, :, :], dim=1) \
            + emis[t]
        v = torch.where((t < lengths)[:, None], new_v, v)
        fin = torch.amax(v + log_end[None, :], dim=1)
        best = torch.where(t == lengths - 1, fin, best)
    if not return_path:
        return best, None, None
    # v is frozen at each read's own last column
    end_state = torch.argmax(v + log_end[None, :], dim=1).int()
    log_T_t = log_T.T
    cur = end_state
    cols = [None] * L
    for t in range(L - 1, 0, -1):
        cols[t] = cur
        prev = torch.argmax(planes[t - 1] + log_T_t[cur.long()],
                            dim=1).int()
        cur = torch.where(t <= lengths - 1, prev, cur)
    cols[0] = cur
    path = torch.stack(cols, dim=1)
    path = torch.where((lengths == 1)[:, None], end_state[:, None], path)
    return best, end_state, path


# exp of anything below this is under 2**-125 in float32
_EXP_FLOOR = -87.0

# float32's smallest normal number
_TINY = torch.finfo(torch.float32).tiny


def lse_(x: torch.Tensor, dim: int) -> torch.Tensor:
    """log-sum-exp over ``dim`` as the reference writes it (max,
    subtract, exp, sum, log); ``x`` is a temporary and is overwritten.

    The differences are clamped at _EXP_FLOOR before the exp, on every
    device: most terms of a sum-closed model sit at the -1e30 floor, and
    torch's CPU exp takes about ten times as long where its result
    underflows.  XLA flushes those results to zero; a clamped term adds
    at most 2**-125 to a sum that holds the maximum's exp(0) = 1, which
    no float32 sum of a few thousand terms can show."""
    mx = torch.amax(x, dim=dim)
    x.sub_(mx.unsqueeze(dim))
    x.clamp_(min=_EXP_FLOOR)
    return mx + torch.log(x.exp_().sum(dim=dim))


def flush_(x: torch.Tensor) -> torch.Tensor:
    """Zero, in place, the entries of a non-negative float32 tensor that
    are under float32's smallest normal number.  XLA flushes subnormal
    results to zero, while torch keeps them on the CPU; expected counts
    pass through this on every device, so that a state the reference
    sees no mass in (and whose row its M-step keeps) gets none here
    either."""
    return x.masked_fill_(x < _TINY, 0.0)


def exp_ftz(x: torch.Tensor) -> torch.Tensor:
    """exp with subnormal results flushed to zero (``flush_``)."""
    return flush_(torch.exp(x))


# on the CPU, reads go through lse_sum in groups of about this many
# (n, n) elements, so that each group's temporary stays in cache
_CPU_GROUP = 1 << 18


def lse_sum(a: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
    """log-sum-exp over ``dim`` of ``a + b``: ``a`` is per read, (B, n, 1)
    or (B, 1, n), ``b`` the (1, n, n) table.  On the card one (B, n, n)
    temporary; on the CPU a few reads at a time, so that each group's
    temporary stays in cache.  Each read's sums are its own, so the
    grouping changes no value."""
    if a.device.type != "cpu":
        return lse_(a + b, dim)
    step = max(1, _CPU_GROUP // (b.shape[-1] * b.shape[-2]))
    return torch.cat([lse_(a[i:i + step] + b, dim)
                      for i in range(0, a.shape[0], step)])


def forward_batch(log_T, log_E, log_start, log_end, seqs, lengths):
    """Batched forward log-likelihood (viterbi.py:138) over the
    sum-closed tables of ``compile_graph_sum``, with viterbi_batch's
    freezes.  Returns loglik (B,)."""
    B, L = seqs.shape
    lengths = lengths.long()
    emis = emissions(log_E, seqs)
    v = log_start[None, :] + emis[0]
    best = lse_(v + log_end[None, :], 1)
    for t in range(1, L):
        new_v = lse_sum(v[:, :, None], log_T[None, :, :], 1) + emis[t]
        v = torch.where((t < lengths)[:, None], new_v, v)
        fin = lse_(v + log_end[None, :], 1)
        best = torch.where(t == lengths - 1, fin, best)
    return best


def prepare_model_tensors(art, device, dtype=torch.float32):
    """A ModelArtifact's tables with -inf replaced by the float32-safe
    NEG32, on ``device`` (viterbi.py:169)."""
    def clean(x):
        x = np.asarray(x, dtype=np.float64)
        x = np.where(np.isfinite(x), x, np.float64(NEG32))
        return torch.as_tensor(x, dtype=dtype, device=device)
    return (clean(art.log_T), clean(art.log_E),
            clean(art.log_start), clean(art.log_end))
