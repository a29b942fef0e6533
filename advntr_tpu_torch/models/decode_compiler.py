"""Decode-only model compile: the part of ``compile_graph``'s artifact that
the default decode reads, from the graph's edges in sparse form.

``compile_decode(g)`` returns what ``bank.decode_payload(compile_graph(g),
sm)[0]`` holds: every field of ``compile_graph``'s artifact bit for bit,
with its O(n^2) tables (``bank.DENSE_FIELDS``: ``log_T``, ``t_unit_*``,
``hop_choice``, ``closure_parent``) left None.  What it keeps is O(n): the
emissions and the states' metadata, the start closure and the start
vector, and the closure's column at END with its unit crossings.  The
closure of an emitting state through the silent DAG reads only that
state's own row, so each row is walked alone
(``csrc/model_closure.cc::model_decode_closure``; without a toolchain,
NumPy over blocks of ``_ROWS`` rows), in ``compile_graph``'s topological
order and edge order with its strict ``>``: the same values and the same
ties, with no (n_e x n_e) or (n_e x n_s) table.
"""

from __future__ import annotations

import itertools
import os

import numpy as np

from advntr_tpu_torch.models.compiler import (NEG, ModelArtifact,
                                              _topo_sort_silent)
from advntr_tpu_torch.models.graph import K_MATCH, HmmGraph

# closure rows the NumPy fallback walks at once
_ROWS = 256


def _native():
    """The native closure loops, or None where ``ADVNTR_TPU_NO_NATIVE=1``
    or no toolchain builds them (as ``compile_graph`` decides)."""
    if os.environ.get("ADVNTR_TPU_NO_NATIVE", "0") == "1":
        return None
    try:
        from advntr_tpu_torch.native_bridge import load_closure
        return load_closure()
    except Exception:
        return None


def _log(p: np.ndarray) -> np.ndarray:
    """``np.log(p) if p > 0 else -inf`` of each probability, taken as
    ``compile_graph`` takes it, one scalar call a distinct value, so the
    same bits."""
    values, inverse = np.unique(p, return_inverse=True)
    logs = np.array([np.log(v) if v > 0 else NEG for v in values.tolist()],
                    dtype=np.float64)
    return logs[inverse].reshape(p.shape)


def _csr(rows, cols, w, n: int, order):
    """(offsets, columns, weights) of the edges of ``n`` rows, each row's
    edges in ``order``'s order."""
    count = np.zeros(n + 1, dtype=np.int32)
    count[1:] = np.cumsum(np.bincount(rows, minlength=n))
    return (count, np.ascontiguousarray(cols[order], dtype=np.int32),
            np.ascontiguousarray(w[order], dtype=np.float64))


def _end_column(es, ss, is_us, is_ue, end_s, log_end, e_us, e_ue):
    """``compile_graph``'s NumPy closure loop over blocks of rows, from
    the lowest silent target of the block up to END."""
    es_count, es_dst, es_w = es
    ss_count = ss[0].tolist()
    ss_src, ss_w = ss[1].tolist(), ss[2].tolist()
    n_e = len(es_count) - 1
    for r0 in range(0, n_e, _ROWS):
        r1 = min(r0 + _ROWS, n_e)
        e0, e1 = es_count[r0], es_count[r1]
        row = np.repeat(np.arange(r1 - r0), np.diff(es_count[r0:r1 + 1]))
        dst, w = es_dst[e0:e1], es_w[e0:e1]
        near = dst <= end_s
        if not near.any():
            continue
        row, dst, w = row[near], dst[near], w[near]
        lo = int(dst.min())
        C = np.full((r1 - r0, end_s + 1 - lo), NEG)
        cu = np.zeros(C.shape, dtype=np.int16)
        ce = np.zeros(C.shape, dtype=np.int16)
        C[row, dst - lo] = w
        cu[row, dst - lo] = is_us[dst]
        ce[row, dst - lo] = is_ue[dst]
        for k in range(lo, end_s + 1):
            for e in range(ss_count[k], ss_count[k + 1]):
                src = ss_src[e]
                if src < lo:
                    continue
                cand = C[:, src - lo] + ss_w[e]
                better = cand > C[:, k - lo]
                if better.any():
                    C[better, k - lo] = cand[better]
                    cu[better, k - lo] = cu[better, src - lo] + is_us[k]
                    ce[better, k - lo] = ce[better, src - lo] + is_ue[k]
        log_end[r0:r1] = C[:, -1]
        e_us[r0:r1] = cu[:, -1]
        e_ue[r0:r1] = ce[:, -1]


def _start(ss, se, is_us, is_ue, C0, p0, c0_us, c0_ue, log_start,
           start_choice, s_us, s_ue):
    """``compile_graph``'s start closure, then its start vector in the
    same (k, j) order."""
    (ss_count, ss_src, ss_w), (se_count, se_dst, se_w) = \
        [[a.tolist() for a in csr] for csr in (ss, se)]
    for k in range(len(ss_count) - 1):
        for e in range(ss_count[k], ss_count[k + 1]):
            src = ss_src[e]
            cand0 = C0[src] + ss_w[e]
            if cand0 > C0[k]:
                C0[k] = cand0
                p0[k] = src
                c0_us[k] = c0_us[src] + is_us[k]
                c0_ue[k] = c0_ue[src] + is_ue[k]
    for k in range(len(se_count) - 1):
        if C0[k] == NEG:
            continue
        for e in range(se_count[k], se_count[k + 1]):
            j = se_dst[e]
            cand0 = C0[k] + se_w[e]
            if cand0 > log_start[j]:
                log_start[j] = cand0
                start_choice[j] = k
                s_us[j] = c0_us[k]
                s_ue[j] = c0_ue[k]


def compile_decode(g: HmmGraph) -> ModelArtifact:
    """``compile_graph(g)`` less its dense tables (None), at O(n) memory
    and O(n_e x silent edges) work."""
    emitting = [i for i, s in enumerate(g.states)
                if not s.is_silent and i not in (g.start, g.end)]
    silent = [i for i, s in enumerate(g.states)
              if s.is_silent or i in (g.start, g.end)]
    topo = _topo_sort_silent(g, silent)
    n_e, n_s = len(emitting), len(topo)

    # each graph state's index: among the emitting states (>= 0), or
    # -1 - its index in the silent order
    place = np.empty(len(g.states), dtype=np.int64)
    place[emitting] = np.arange(n_e)
    place[topo] = -1 - np.arange(n_s)
    start_s, end_s = int(-1 - place[g.start]), int(-1 - place[g.end])

    # the edges the decode payload reads, finite weights only (an edge of
    # weight -inf never wins); emitting->emitting edges feed only log_T
    ends = np.fromiter(itertools.chain.from_iterable(g.edges), np.int64,
                       2 * len(g.edges)).reshape(-1, 2)
    a, b = place[ends[:, 0]], place[ends[:, 1]]
    w = _log(np.fromiter(g.edges.values(), np.float64, len(g.edges)))
    live = w != NEG
    m = live & (a >= 0) & (b < 0)           # emitting i -> silent s
    es = _csr(a[m], -1 - b[m], w[m], n_e, np.argsort(a[m], kind="stable"))
    m = live & (a < 0) & (b < 0)            # silent in-edges of k, in order
    ss = _csr(-1 - b[m], -1 - a[m], w[m], n_s,
              np.argsort(-1 - b[m], kind="stable"))
    m = live & (a < 0) & (b >= 0)           # silent k -> emitting j, j up
    se = _csr(-1 - a[m], b[m], w[m], n_s, np.lexsort((b[m], -1 - a[m])))

    is_us = np.array([g.states[topo[k]].name.startswith("unit_start")
                      for k in range(n_s)], dtype=np.int8)
    is_ue = np.array([g.states[topo[k]].name.startswith("unit_end")
                      for k in range(n_s)], dtype=np.int8)

    log_end = np.full(n_e, NEG)
    e_us = np.zeros(n_e, dtype=np.int16)
    e_ue = np.zeros(n_e, dtype=np.int16)
    C0 = np.full(n_s, NEG)
    C0[start_s] = 0.0
    p0 = np.full(n_s, np.iinfo(np.int32).min, dtype=np.int32)
    p0[start_s] = -1
    c0_us = np.zeros(n_s, dtype=np.int16)
    c0_ue = np.zeros(n_s, dtype=np.int16)
    log_start = np.full(n_e, NEG)
    start_choice = np.full(n_e, -2, dtype=np.int32)
    s_us = np.zeros(n_e, dtype=np.int16)
    s_ue = np.zeros(n_e, dtype=np.int16)

    lib = _native()
    if lib is not None:
        lib.model_decode_closure(
            n_e, n_s, end_s, *es, *ss, *se, is_us, is_ue,
            log_end, e_us, e_ue, C0, p0, c0_us, c0_ue,
            log_start, start_choice, s_us, s_ue)
    else:
        _end_column(es, ss, is_us, is_ue, end_s, log_end, e_us, e_ue)
        _start(ss, se, is_us, is_ue, C0, p0, c0_us, c0_ue, log_start,
               start_choice, s_us, s_ue)

    # ---- emissions + metadata ---------------------------------------------
    states = [g.states[gi] for gi in emitting]
    log_E = _log(np.fromiter((st.emission.get(b, 0.0) for st in states
                              for b in "ACGT"), np.float64, 4 * n_e
                             ).reshape(n_e, 4))
    kind = np.array([st.kind for st in states], dtype=np.int8)
    exp_base = np.full(n_e, -1, dtype=np.int8)
    match = kind == K_MATCH
    exp_base[match] = np.argmax(log_E[match], axis=1)

    def clip8(x):
        return np.minimum(x, 127).astype(np.int8)

    return ModelArtifact(
        log_T=None, log_E=log_E, log_start=log_start, log_end=log_end,
        t_unit_starts=None, t_unit_ends=None,
        s_unit_starts=clip8(s_us), s_unit_ends=clip8(s_ue),
        e_unit_starts=clip8(e_us), e_unit_ends=clip8(e_ue),
        names=[st.name for st in states], kind=kind,
        region=np.array([st.region for st in states], dtype=np.int8),
        pos=np.array([st.pos for st in states], dtype=np.int32),
        unit=np.array([st.unit for st in states], dtype=np.int32),
        exp_base=exp_base,
        silent_names=[g.states[topo[k]].name for k in range(n_s)],
        silent_is_unit_start=is_us, silent_is_unit_end=is_ue,
        hop_choice=None, closure_parent=None,
        start_choice=start_choice, start_parent=p0,
        start_silent=start_s, end_silent=end_s,
    )
