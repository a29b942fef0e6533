"""Model compiler: silent-state elimination into a dense first-order HMM.

The reference engine walks a sparse graph with silent states inside the hot
Viterbi loop: for every symbol it runs three passes (emitting states; silent
states fed by current-column emitting states; silent states fed by
lower-topological-order silent states) — pomegranate/hmm.pyx:2025-2083.
Silent transition weights do not depend on the observation, so the best
silent path between any two emitting states is a compile-time constant.
This module computes the max-plus transitive closure over the silent
subgraph once, producing:

- ``log_T`` (n_e x n_e): effective emitting->emitting transitions
- ``log_start`` / ``log_end``: effective start->state / state->end weights
- ``log_E`` (n_e x 4): emission table (A,C,G,T)
- unit-boundary crossing counts per effective transition (how many
  ``unit_start``/``unit_end`` silent states the best silent path crosses),
  which is what repeat-unit counting consumes (reference semantics:
  hmm_utils.py:155-188)
- decode tables sufficient to re-expand any effective hop into the exact
  silent-state chain (for frameshift analysis and debug-path parity)

The result is a plain first-order HMM a TPU kernel can scan over with no
data-dependent control flow.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from advntr_tpu_torch.models.graph import HmmGraph

NEG = np.float64(-np.inf)


@dataclasses.dataclass
class ModelArtifact:
    """Compiled dense HMM over emitting states + decode metadata."""

    # device tensors (float64 host-side; cast as needed for device)
    log_T: np.ndarray          # (n, n)
    log_E: np.ndarray          # (n, 4)
    log_start: np.ndarray      # (n,)
    log_end: np.ndarray        # (n,)

    # unit-boundary crossings along the best silent path of each hop
    t_unit_starts: np.ndarray  # (n, n) int8
    t_unit_ends: np.ndarray    # (n, n) int8
    s_unit_starts: np.ndarray  # (n,) int8   start->j hop
    s_unit_ends: np.ndarray    # (n,) int8
    e_unit_starts: np.ndarray  # (n,) int8   i->end hop
    e_unit_ends: np.ndarray    # (n,) int8

    # per-emitting-state metadata
    names: list
    kind: np.ndarray           # (n,) K_MATCH/K_INSERT/K_OTHER
    region: np.ndarray         # (n,) R_SUFFIX/R_REPEAT/R_PREFIX/R_OTHER
    pos: np.ndarray            # (n,) profile column
    unit: np.ndarray           # (n,) repeat-copy index or -1
    exp_base: np.ndarray       # (n,) argmax emission base for M states, -1 else

    # decode tables for exact silent-chain re-expansion
    silent_names: list
    silent_is_unit_start: np.ndarray
    silent_is_unit_end: np.ndarray
    # hop (i -> j): last silent state on best path, or -1 if the hop is a
    # direct emitting->emitting edge, -2 if unreachable
    hop_choice: np.ndarray     # (n, n) int32
    # best-path parent of silent s when the chain starts at emitting i:
    # >=0: previous silent state; -1: direct edge i->s; INT32_MIN: unreachable
    closure_parent: np.ndarray  # (n, n_s) int32
    start_choice: np.ndarray    # (n,) int32: last silent before emitting j on
                                # the start hop (-2 unreachable)
    start_parent: np.ndarray    # (n_s,) int32 parent along closure from START
    start_silent: int           # index of START in the silent ordering
    end_silent: int             # index of END in the silent ordering

    @property
    def n_states(self) -> int:
        # log_E, not log_T: slim bank payloads strip the dense tables
        return self.log_E.shape[0]

    @property
    def n_silent(self) -> int:
        return len(self.silent_names)


def _topo_sort_silent(g: HmmGraph, silent: list[int]) -> list[int]:
    silent_set = set(silent)
    indeg = {s: 0 for s in silent}
    adj: dict[int, list[int]] = {s: [] for s in silent}
    for (a, b) in g.edges:
        if a in silent_set and b in silent_set:
            adj[a].append(b)
            indeg[b] += 1
    order, stack = [], [s for s in silent if indeg[s] == 0]
    while stack:
        s = stack.pop()
        order.append(s)
        for t in adj[s]:
            indeg[t] -= 1
            if indeg[t] == 0:
                stack.append(t)
    if len(order) != len(silent):
        raise ValueError("silent-state subgraph contains a cycle")
    return order


def compile_graph(g: HmmGraph) -> ModelArtifact:
    from advntr_tpu_torch.models.graph import K_MATCH
    n_all = len(g.states)
    emitting = [i for i, s in enumerate(g.states)
                if not s.is_silent and i not in (g.start, g.end)]
    silent = [i for i, s in enumerate(g.states)
              if s.is_silent or i in (g.start, g.end)]

    topo = _topo_sort_silent(g, silent)
    # position of graph-state in the compiled orderings
    e_of = {s: k for k, s in enumerate(emitting)}
    s_of = {s: k for k, s in enumerate(topo)}
    n_e, n_s = len(emitting), len(topo)
    start_s, end_s = s_of[g.start], s_of[g.end]

    with np.errstate(divide="ignore"):
        def lg(p):
            return np.log(p) if p > 0 else NEG

        # direct edge matrices in log space
        W_ee = np.full((n_e, n_e), NEG)
        W_es = np.full((n_e, n_s), NEG)
        W_se = np.full((n_s, n_e), NEG)
        ss_edges: list[list[tuple[int, float]]] = [[] for _ in range(n_s)]
        for (a, b), p in g.edges.items():
            w = lg(p)
            if a in e_of and b in e_of:
                W_ee[e_of[a], e_of[b]] = w
            elif a in e_of:
                W_es[e_of[a], s_of[b]] = w
            elif b in e_of:
                W_se[s_of[a], e_of[b]] = w
            else:
                ss_edges[s_of[b]].append((s_of[a], w))

    # crossing indicator per silent state
    is_us = np.array([g.states[topo[k]].name.startswith("unit_start")
                      for k in range(n_s)], dtype=np.int8)
    is_ue = np.array([g.states[topo[k]].name.startswith("unit_end")
                      for k in range(n_s)], dtype=np.int8)

    # ---- closure from every emitting state through the silent DAG ----------
    # C[i, s] = best log-weight of i -> (silent chain) -> s
    C = W_es.copy()
    parent = np.where(np.isfinite(W_es), -1, np.iinfo(np.int32).min
                      ).astype(np.int32)
    cross_us = (np.isfinite(W_es) * is_us[None, :]).astype(np.int16)
    cross_ue = (np.isfinite(W_es) * is_ue[None, :]).astype(np.int16)
    C0 = np.full(n_s, NEG)
    C0[start_s] = 0.0
    p0 = np.full(n_s, np.iinfo(np.int32).min, dtype=np.int32)
    p0[start_s] = -1
    c0_us = np.zeros(n_s, dtype=np.int16)
    c0_ue = np.zeros(n_s, dtype=np.int16)
    log_T = W_ee.copy()
    hop_choice = np.where(np.isfinite(W_ee), -1, -2).astype(np.int32)
    t_us = np.zeros((n_e, n_e), dtype=np.int16)
    t_ue = np.zeros((n_e, n_e), dtype=np.int16)
    log_start = np.full(n_e, NEG)
    start_choice = np.full(n_e, -2, dtype=np.int32)
    s_us = np.zeros(n_e, dtype=np.int16)
    s_ue = np.zeros(n_e, dtype=np.int16)

    lib = None
    if os.environ.get("ADVNTR_TPU_NO_NATIVE", "0") != "1":
        try:
            from advntr_tpu_torch.native_bridge import load_closure
            lib = load_closure()
        except Exception:
            lib = None
    if lib is not None:
        # native path: identical loop semantics (strict >, first-wins,
        # crossings along the argmax path) as flat C loops
        ss_count = np.zeros(n_s + 1, dtype=np.int32)
        ss_src, ss_w = [], []
        for k in range(n_s):
            ss_count[k + 1] = ss_count[k] + len(ss_edges[k])
            for (src, w) in ss_edges[k]:
                ss_src.append(src)
                ss_w.append(w)
        lib.model_closure(
            n_e, n_s, ss_count,
            np.asarray(ss_src, dtype=np.int32),
            np.asarray(ss_w, dtype=np.float64),
            is_us, is_ue, np.ascontiguousarray(W_se),
            C, parent, cross_us, cross_ue,
            C0, p0, c0_us, c0_ue,
            log_T, hop_choice, t_us, t_ue,
            log_start, start_choice, s_us, s_ue)
    else:
        for k in range(n_s):  # topo order
            for (src, w) in ss_edges[k]:
                cand = C[:, src] + w
                better = cand > C[:, k]
                if better.any():
                    C[better, k] = cand[better]
                    parent[better, k] = src
                    cross_us[better, k] = cross_us[better, src] + is_us[k]
                    cross_ue[better, k] = cross_ue[better, src] + is_ue[k]
                cand0 = C0[src] + w
                if cand0 > C0[k]:
                    C0[k] = cand0
                    p0[k] = src
                    c0_us[k] = c0_us[src] + is_us[k]
                    c0_ue[k] = c0_ue[src] + is_ue[k]

        # ---- effective transition matrix + start vector --------------------
        for k in range(n_s):
            outs = np.nonzero(np.isfinite(W_se[k]))[0]
            if outs.size == 0:
                continue
            if np.isfinite(C[:, k]).any():
                for j in outs:
                    cand = C[:, k] + W_se[k, j]
                    better = cand > log_T[:, j]
                    if better.any():
                        log_T[better, j] = cand[better]
                        hop_choice[better, j] = k
                        t_us[better, j] = cross_us[better, k]
                        t_ue[better, j] = cross_ue[better, k]
            if np.isfinite(C0[k]):
                for j in outs:
                    cand0 = C0[k] + W_se[k, j]
                    if cand0 > log_start[j]:
                        log_start[j] = cand0
                        start_choice[j] = k
                        s_us[j] = c0_us[k]
                        s_ue[j] = c0_ue[k]

    log_end = C[:, end_s].copy()
    e_us = cross_us[:, end_s].copy()
    e_ue = cross_ue[:, end_s].copy()

    # ---- emissions + metadata ---------------------------------------------
    log_E = np.full((n_e, 4), NEG)
    kind = np.zeros(n_e, dtype=np.int8)
    region = np.zeros(n_e, dtype=np.int8)
    pos = np.zeros(n_e, dtype=np.int32)
    unit = np.zeros(n_e, dtype=np.int32)
    exp_base = np.full(n_e, -1, dtype=np.int8)
    names = []
    for i, gi in enumerate(emitting):
        st = g.states[gi]
        names.append(st.name)
        for b, bi in zip("ACGT", range(4)):
            p = st.emission.get(b, 0.0)
            log_E[i, bi] = np.log(p) if p > 0 else NEG
        kind[i] = st.kind
        region[i] = st.region
        pos[i] = st.pos
        unit[i] = st.unit
        if st.kind == K_MATCH:
            exp_base[i] = int(np.argmax(log_E[i]))

    return ModelArtifact(
        log_T=log_T, log_E=log_E, log_start=log_start, log_end=log_end,
        t_unit_starts=np.minimum(t_us, 127).astype(np.int8),
        t_unit_ends=np.minimum(t_ue, 127).astype(np.int8),
        s_unit_starts=np.minimum(s_us, 127).astype(np.int8),
        s_unit_ends=np.minimum(s_ue, 127).astype(np.int8),
        e_unit_starts=np.minimum(e_us, 127).astype(np.int8),
        e_unit_ends=np.minimum(e_ue, 127).astype(np.int8),
        names=names, kind=kind, region=region, pos=pos, unit=unit,
        exp_base=exp_base,
        silent_names=[g.states[topo[k]].name for k in range(n_s)],
        silent_is_unit_start=is_us, silent_is_unit_end=is_ue,
        hop_choice=hop_choice, closure_parent=parent,
        start_choice=start_choice, start_parent=p0,
        start_silent=start_s, end_silent=end_s,
    )


# ---------------------------------------------------------------------------
# exact path re-expansion
# ---------------------------------------------------------------------------

def _silent_chain(art: ModelArtifact, i: int | None, last_silent: int) -> list[int]:
    """Walk closure parents back from `last_silent` for a chain that started
    at emitting state i (or at START if i is None)."""
    chain = []
    s = last_silent
    parents = art.closure_parent[i] if i is not None else art.start_parent
    while s >= 0:
        chain.append(s)
        p = parents[s]
        if p == -1:
            break
        s = p
    chain.reverse()
    return chain


def expand_path(art: ModelArtifact, state_path) -> list[str]:
    """Re-expand an emitting-state Viterbi path into the full visited-state
    name sequence (reference ``vpath[1:-1]`` equivalent: excludes the model's
    own start/end states but includes every inner silent state)."""
    out: list[str] = []

    def emit_chain(i, last_silent):
        for s in _silent_chain(art, i, last_silent):
            if s == art.start_silent or s == art.end_silent:
                continue  # the model's own start/end (vpath[1:-1] semantics)
            out.append(art.silent_names[s])

    if len(state_path) == 0:
        return out
    j0 = int(state_path[0])
    if art.start_choice[j0] >= 0:
        emit_chain(None, art.start_choice[j0])
    out.append(art.names[j0])
    for t in range(1, len(state_path)):
        i, j = int(state_path[t - 1]), int(state_path[t])
        ch = art.hop_choice[i, j]
        if ch >= 0:
            emit_chain(i, ch)
        out.append(art.names[j])
    emit_chain(int(state_path[-1]), art.end_silent)
    return out


def compile_graph_sum(g: HmmGraph, drop_silent=None):
    """Sum-semiring (forward-algorithm) silent-state elimination.

    Like compile_graph but closing silent chains with log-sum-exp instead of
    max — exact for the forward algorithm because silent-path weights are
    observation-independent, so total path probability factorizes through
    the summed silent closure.  Returns (log_T, log_E, log_start, log_end)
    float64 arrays over the same emitting-state ordering as compile_graph.

    ``drop_silent``: optional predicate over silent StateDefs; silent states
    matching it are removed from the closure (all their in/out edges
    dropped), yielding the total weight of silent routes that AVOID them.
    The posterior-deletion decomposition (ops/posterior.py) subtracts this
    restricted closure from the full one.
    """
    n_all = len(g.states)
    emitting = [i for i, s in enumerate(g.states)
                if not s.is_silent and i not in (g.start, g.end)]
    silent = [i for i, s in enumerate(g.states)
              if s.is_silent or i in (g.start, g.end)]
    dropped = set()
    if drop_silent is not None:
        dropped = {i for i in silent
                   if i not in (g.start, g.end) and drop_silent(g.states[i])}
    topo = _topo_sort_silent(g, silent)
    e_of = {s: k for k, s in enumerate(emitting)}
    s_of = {s: k for k, s in enumerate(topo)}
    n_e, n_s = len(emitting), len(topo)
    start_s, end_s = s_of[g.start], s_of[g.end]

    with np.errstate(divide="ignore"):
        def lg(p):
            return np.log(p) if p > 0 else NEG
        W_ee = np.full((n_e, n_e), NEG)
        W_es = np.full((n_e, n_s), NEG)
        W_se = np.full((n_s, n_e), NEG)
        ss_edges: list[list[tuple[int, float]]] = [[] for _ in range(n_s)]
        for (a, b), p in g.edges.items():
            if a in dropped or b in dropped:
                continue
            w = lg(p)
            if a in e_of and b in e_of:
                W_ee[e_of[a], e_of[b]] = w
            elif a in e_of:
                W_es[e_of[a], s_of[b]] = w
            elif b in e_of:
                W_se[s_of[a], e_of[b]] = w
            else:
                ss_edges[s_of[b]].append((s_of[a], w))

    C = W_es.copy()
    for k in range(n_s):
        for (src, w) in ss_edges[k]:
            C[:, k] = np.logaddexp(C[:, k], C[:, src] + w)
    C0 = np.full(n_s, NEG)
    C0[start_s] = 0.0
    for k in range(n_s):
        for (src, w) in ss_edges[k]:
            C0[k] = np.logaddexp(C0[k], C0[src] + w)

    log_T = W_ee.copy()
    log_start = np.full(n_e, NEG)
    for k in range(n_s):
        outs = np.nonzero(np.isfinite(W_se[k]))[0]
        for j in outs:
            log_T[:, j] = np.logaddexp(log_T[:, j], C[:, k] + W_se[k, j])
            log_start[j] = np.logaddexp(log_start[j], C0[k] + W_se[k, j])
    log_end = C[:, end_s].copy()

    log_E = np.full((n_e, 4), NEG)
    for i, gi in enumerate(emitting):
        st = g.states[gi]
        for bi, b in enumerate("ACGT"):
            p = st.emission.get(b, 0.0)
            log_E[i, bi] = np.log(p) if p > 0 else NEG
    return log_T, log_E, log_start, log_end


def forward_full_graph(g: HmmGraph, codes: np.ndarray) -> float:
    """Forward-algorithm oracle over the full graph with silent states
    (reference semantics: pomegranate/hmm.pyx:1371 — same pass structure as
    Viterbi but with log-sum-exp accumulation)."""
    emitting = [i for i, s in enumerate(g.states)
                if not s.is_silent and i not in (g.start, g.end)]
    silent_topo = _topo_sort_silent(
        g, [i for i, s in enumerate(g.states)
            if s.is_silent or i in (g.start, g.end)])
    order = emitting + silent_topo
    o_of = {s: k for k, s in enumerate(order)}
    m = len(order)
    silent_start = len(emitting)
    start_o, end_o = o_of[g.start], o_of[g.end]
    in_edges: list[list[tuple[int, float]]] = [[] for _ in range(m)]
    with np.errstate(divide="ignore"):
        for (a, b), p in g.edges.items():
            in_edges[o_of[b]].append((o_of[a], np.log(p) if p > 0 else NEG))
    log_e = np.full((m, 4), NEG)
    for k in range(silent_start):
        st = g.states[order[k]]
        for bi, b in enumerate("ACGT"):
            p = st.emission.get(b, 0.0)
            log_e[k, bi] = np.log(p) if p > 0 else NEG

    n = len(codes)
    v = np.full(m, NEG)
    v[start_o] = 0.0
    for l in range(silent_start, m):
        if l == start_o:
            continue
        for (ki, w) in in_edges[l]:
            if ki < silent_start or ki >= l:
                continue
            v[l] = np.logaddexp(v[l], v[ki] + w)
    for i in range(n):
        nv = np.full(m, NEG)
        for l in range(silent_start):
            for (ki, w) in in_edges[l]:
                nv[l] = np.logaddexp(nv[l], v[ki] + w)
            nv[l] += log_e[l, codes[i]]
        for l in range(silent_start, m):
            for (ki, w) in in_edges[l]:
                if ki >= silent_start:
                    continue
                nv[l] = np.logaddexp(nv[l], nv[ki] + w)
        for l in range(silent_start, m):
            for (ki, w) in in_edges[l]:
                if ki < silent_start or ki >= l:
                    continue
                nv[l] = np.logaddexp(nv[l], nv[ki] + w)
        v = nv
    return float(v[end_o])


def score_visited_path(g: HmmGraph, visited: list[str],
                       codes: np.ndarray) -> float:
    """Score a full visited-state path (names, excluding model start/end)
    against the graph: sum of transition log-weights plus emissions.
    Used in tests to verify that two tie-broken optimal paths score equally."""
    idx = [g.idx(n) for n in visited]
    chain = [g.start] + idx + [g.end]
    total = 0.0
    with np.errstate(divide="ignore"):
        for a, b in zip(chain[:-1], chain[1:]):
            p = g.edges.get((a, b), 0.0)
            total += np.log(p) if p > 0 else NEG
    bp = 0
    for i in idx:
        st = g.states[i]
        if not st.is_silent:
            p = st.emission.get("ACGT"[codes[bp]], 0.0)
            total += np.log(p) if p > 0 else NEG
            bp += 1
    return float(total)


# ---------------------------------------------------------------------------
# oracle: exact reference recurrence over the full graph (test-only)
# ---------------------------------------------------------------------------

def viterbi_full_graph(g: HmmGraph, codes: np.ndarray):
    """Reference-semantics Viterbi over the full graph with silent states.

    Implements the exact three-pass recurrence of the reference kernel
    (pomegranate/hmm.pyx:2002-2130): states ordered emitting-first then
    silent-topological; per symbol pass (a) emitting from previous column,
    (b) silent from current-column emitting, (c) silent from lower-topo
    silent; final answer at column n's end state.  float64, first-better-wins
    tie-breaking.  Slow; used as the conformance oracle for the compiled
    artifact and the device kernels.
    """
    emitting = [i for i, s in enumerate(g.states)
                if not s.is_silent and i not in (g.start, g.end)]
    silent_topo = _topo_sort_silent(
        g, [i for i, s in enumerate(g.states)
            if s.is_silent or i in (g.start, g.end)])
    order = emitting + silent_topo
    o_of = {s: k for k, s in enumerate(order)}
    m = len(order)
    silent_start = len(emitting)
    start_o, end_o = o_of[g.start], o_of[g.end]

    in_edges: list[list[tuple[int, float]]] = [[] for _ in range(m)]
    with np.errstate(divide="ignore"):
        for (a, b), p in g.edges.items():
            in_edges[o_of[b]].append((o_of[a], np.log(p) if p > 0 else NEG))

    log_e = np.full((m, 4), NEG)
    for k in range(silent_start):
        st = g.states[order[k]]
        for b, bi in zip("ACGT", range(4)):
            p = st.emission.get(b, 0.0)
            log_e[k, bi] = np.log(p) if p > 0 else NEG

    n = len(codes)
    v = np.full((n + 1, m), NEG)
    tb = np.full((n + 1, m, 2), -1, dtype=np.int64)  # (col, state)
    v[0, start_o] = 0.0
    for l in range(silent_start, m):
        if l == start_o:
            continue
        for (ki, w) in in_edges[l]:
            if ki < silent_start or ki >= l:
                continue
            cand = v[0, ki] + w
            if cand > v[0, l]:
                v[0, l] = cand
                tb[0, l] = (0, ki)

    for i in range(n):
        e_col = log_e[:silent_start, codes[i]]
        for l in range(silent_start):
            for (ki, w) in in_edges[l]:
                cand = v[i, ki] + w + e_col[l]
                if cand > v[i + 1, l]:
                    v[i + 1, l] = cand
                    tb[i + 1, l] = (i, ki)
        for l in range(silent_start, m):
            for (ki, w) in in_edges[l]:
                if ki >= silent_start:
                    continue
                cand = v[i + 1, ki] + w
                if cand > v[i + 1, l]:
                    v[i + 1, l] = cand
                    tb[i + 1, l] = (i + 1, ki)
        for l in range(silent_start, m):
            for (ki, w) in in_edges[l]:
                if ki < silent_start or ki >= l:
                    continue
                cand = v[i + 1, ki] + w
                if cand > v[i + 1, l]:
                    v[i + 1, l] = cand
                    tb[i + 1, l] = (i + 1, ki)

    logp = v[n, end_o]
    if not np.isfinite(logp):
        return logp, None
    path = []
    px, py = n, end_o
    while px != 0 or py != start_o:
        path.append(py)
        px, py = tb[px, py]
        py = int(py)
        px = int(px)
    path.append(py)
    path.reverse()
    names = [g.states[order[k]].name for k in path]
    return logp, names
