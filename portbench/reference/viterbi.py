"""Viterbi over a compiled read-matcher graph, in plain PyTorch.

The recurrence is pomegranate's three passes per read base: every
emitting state from all states of the previous column; every silent state
from the emitting states of this column; then the silent states in
topological order from the silent states before them.  The last pass runs
along chains of silent states (delete runs, unit connectors): inside a run
``x_k = max(a_k, x_{k-1} + w_k)``, which is ``S_k + cummax_j(a_j - S_j)``
with ``S`` the running sum of the run's weights, so a run costs a few
tensor operations and not one per state.  Rows are reads; ``logp`` is the
best path's log probability at the end state after the read's last base,
and the decoded path is returned as visited state positions.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.hmm import Compiled

NEG = float("-inf")


class Decoder:
    """One compiled graph on a device, in a dtype (float64 for the
    reference, a lower one for its control)."""

    def __init__(self, c: Compiled, device, dtype=torch.float64):
        self.c = c
        self.dev = torch.device(device)
        self.dtype = dtype
        on = lambda x, dt=None: torch.as_tensor(x, device=self.dev,
                                                dtype=dt)
        self.E, self.n = c.n_emit, c.n
        self.log_emit_t = on(c.log_emit.T.copy(), dtype)      # (4, E)
        self.e_src = on(c.e_src)
        self.e_w = on(c.e_w, dtype)
        self.se_src = on(c.se_src)
        self.se_dst = on(c.se_dst - c.n_emit)
        self.se_w = on(c.se_w, dtype)
        self.se_rank = torch.arange(len(c.se_src), device=self.dev)
        self.runs = []
        for first, last in c.runs:
            S = np.concatenate([[0.0], np.cumsum(c.run_w[first + 1:last])])
            preds = [(p, w) for p, w in c.ss_preds[first]]
            self.runs.append((first, last, on(S, dtype), preds))

    def _silent(self, v, a, a_ptr, ptr):
        """Fill the silent part of ``v`` (B, n) and ``ptr`` from ``a`` (the
        best of each silent state over this column's emitting states)."""
        E = self.E
        for first, last, S, preds in self.runs:
            head = a[:, first - E]
            head_ptr = a_ptr[:, first - E]
            for p, w in preds:
                cand = v[:, p] + w
                better = cand > head
                head = torch.where(better, cand, head)
                head_ptr = torch.where(better, p, head_ptr)
            v[:, first] = head
            ptr[:, first] = head_ptr.to(ptr.dtype)
            if last - first == 1:
                continue
            c = a[:, first - E:last - E] - S
            c[:, 0] = head
            cm, idx = torch.cummax(c, dim=1)
            v[:, first:last] = S + cm
            k = torch.arange(first, last, device=self.dev)
            entered = idx == (k - first)
            ptr[:, first + 1:last] = torch.where(
                entered[:, 1:], a_ptr[:, first + 1 - E:last - E],
                (k[1:] - 1)[None, :]).to(ptr.dtype)

    def _from_emitting(self, e):
        """(a, a_ptr): each silent state's best over the emitting states of
        the column, first edge first among equals."""
        B = e.shape[0]
        S = self.n - self.E
        cand = e[:, self.se_src] + self.se_w
        a = torch.full((B, S), NEG, device=self.dev, dtype=self.dtype)
        dst = self.se_dst[None, :].expand(B, -1)
        a = a.scatter_reduce(1, dst, cand, "amax", include_self=True)
        is_best = (cand == a.gather(1, dst)) & (cand > NEG)
        rank = torch.where(is_best, self.se_rank[None, :],
                           len(self.se_rank))
        first = torch.full((B, S), len(self.se_rank), device=self.dev,
                           dtype=torch.int64)
        first = first.scatter_reduce(1, dst, rank, "amin", include_self=True)
        a_ptr = torch.where(first < len(self.se_rank),
                            self.se_src[first.clamp(max=len(self.se_rank) - 1)],
                            -1)
        return a, a_ptr

    def decode(self, codes: list[np.ndarray]):
        """(logp (B,) float64 numpy, [visited positions of each read])."""
        B = len(codes)
        L = max(len(x) for x in codes)
        lens = torch.as_tensor([len(x) for x in codes], device=self.dev)
        seqs = torch.zeros((B, L), dtype=torch.int64, device=self.dev)
        for b, x in enumerate(codes):
            seqs[b, :len(x)] = torch.as_tensor(x.astype(np.int64))
        E, n, c = self.E, self.n, self.c
        pdt = torch.int16 if n < 32768 else torch.int32
        v = torch.full((B, n), NEG, device=self.dev, dtype=self.dtype)
        ptr = torch.full((B, n), -1, device=self.dev, dtype=pdt)
        a = torch.full((B, n - E), NEG, device=self.dev, dtype=self.dtype)
        a[:, c.start - E] = 0.0
        a_ptr = torch.full((B, n - E), -1, device=self.dev, dtype=torch.int64)
        self._silent(v, a, a_ptr, ptr)
        ptrs = [ptr]
        logp = torch.full((B,), NEG, device=self.dev, dtype=torch.float64)
        rows = torch.arange(E, device=self.dev)
        for t in range(L):
            cand = v[:, self.e_src] + self.e_w
            best, arg = cand.max(dim=2)
            e = best + self.log_emit_t[seqs[:, t]]
            nv = torch.full_like(v, NEG)
            nptr = torch.full_like(ptr, -1)
            nv[:, :E] = e
            nptr[:, :E] = self.e_src[rows[None, :], arg].to(pdt)
            a, a_ptr = self._from_emitting(e)
            self._silent(nv, a, a_ptr, nptr)
            v = nv
            ptrs.append(nptr)
            logp = torch.where(lens == t + 1, v[:, c.end]
                               .to(torch.float64), logp)
        return logp.cpu().numpy(), self._traceback(ptrs, lens)

    def _traceback(self, ptrs, lens):
        c = self.c
        B = lens.shape[0]
        P = torch.stack(ptrs)                             # (L+1, B, n)
        cur = torch.full((B,), c.end, device=self.dev, dtype=torch.int64)
        t = lens.clone()
        done = torch.zeros(B, dtype=torch.bool, device=self.dev)
        bidx = torch.arange(B, device=self.dev)
        steps = []
        for k in range(P.shape[0] * self.n + 1):
            steps.append(torch.where(done, -1, cur))
            nxt = P[t, bidx, cur].to(torch.int64)
            now_done = done | ((cur == c.start) & (t == 0)) | (nxt < 0)
            t = torch.where(~now_done & (cur < self.E), t - 1, t)
            cur = torch.where(now_done, cur, nxt)
            done = now_done
            if k % 64 == 63 and bool(done.all()):
                break
        path = torch.stack(steps, dim=1).cpu().numpy()
        out = []
        for b in range(B):
            p = path[b][path[b] >= 0][::-1]
            out.append(p)
        return out
