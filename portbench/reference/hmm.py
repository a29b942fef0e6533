"""adVNTR's read-matcher HMM, built from a locus's database row.

The model of a locus (adVNTR ``hmm_utils.get_read_matcher_model`` with its
``from_matrix`` round trips resolved, as documented upstream):

- a left-flank *suffix matcher*: a profile of the flank's last ``F`` bases
  (match emits the flank base at 0.97, the others at 0.01; inserts
  uniform), entered at any match position, so a read may start mid-flank;
- ``copies`` repeat units, each a profile HMM estimated from the locus's
  repeat segments with pseudocounts (``profile_hmm.py``), chained by
  ``unit_end -> next unit_start`` (0.5) and ``unit_end -> end_repeats``
  (0.5);
- a right-flank *prefix matcher*, entered at its first position, with an
  early exit (0.01) from every match, so a read may end mid-flank;
- the start sends 0.3 into the suffix matcher and 0.7 over the first
  unit's matches; every repeat match renormalises its out-edges to make
  room for a direct exit (``0.7 / repeat matches``) to the prefix
  matcher's end.

Silent states stay in the graph; ``viterbi.py`` decodes it with the
three-pass recurrence of pomegranate.  Only the repeat segments this
benchmark generates (identical copies of the motif) are supported, so the
multiple alignment is the segments themselves.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

ACGT = "ACGT"
# state regions and kinds
SUFFIX, REPEAT, PREFIX, OTHER = 0, 1, 2, 3
MATCH, INSERT, DELETE, SILENT = 0, 1, 2, 3


@dataclasses.dataclass
class State:
    name: str
    emission: tuple | None        # P(A), P(C), P(G), P(T); None: silent
    kind: int = SILENT
    region: int = OTHER
    unit: int = -1
    consensus: int = -1           # the flank base a flank match emits
    unit_start: bool = False
    unit_end: bool = False


class Graph:
    def __init__(self):
        self.states: list[State] = []
        self.edges: dict[tuple[int, int], float] = {}

    def add(self, state: State) -> int:
        self.states.append(state)
        return len(self.states) - 1

    def edge(self, a: int, b: int, p: float) -> None:
        if p != 0.0:
            self.edges[(a, b)] = float(p)


def repeat_profile(segments: list[str], error_rate: float):
    """(transitions, emissions) of one repeat unit, keyed 'unit_start',
    'I0', 'M1', 'D1', ..., 'unit_end', estimated from a gapless alignment
    of ``segments`` with adVNTR's pseudocounts: emissions normalised, then
    ``pseu`` added and renormalised; transitions ``(p + pseu) /
    (1 + pseu * targets)``; unobserved states uniform."""
    if len(set(segments)) != 1:
        raise ValueError("the reference supports identical repeat segments "
                         "only (the benchmark's panels)")
    unit = segments[0]
    n, W = len(segments), len(unit)
    pseu = (n / 4.0) * (error_rate / 10.0)
    emissions = {}
    for i in range(W + 1):
        emissions[f"I{i}"] = (0.25,) * 4
    for i in range(1, W + 1):
        raw = [(n if b == unit[i - 1] else 0) / n + pseu for b in ACGT]
        total = 0.0
        for v in raw:
            total += v
        emissions[f"M{i}"] = tuple(v / total for v in raw)

    def observed(counts: dict) -> dict:
        total = sum(counts.values())
        k = len(counts)
        return {t: (c / total + pseu) / (1 + pseu * k)
                for t, c in counts.items()}

    def uniform(targets) -> dict:
        return {t: 1.0 / len(targets) for t in targets}

    trans = {"unit_start": observed({"I0": 0, "D1": 0, "M1": n}),
             "I0": uniform(["I0", "D1", "M1"])}
    for i in range(1, W + 1):
        nxt = [f"I{i}", f"D{i + 1}", f"M{i + 1}"] if i < W else \
            [f"I{i}", "unit_end"]
        if i < W:
            trans[f"M{i}"] = observed({f"M{i + 1}": n, f"I{i}": 0,
                                       f"D{i + 1}": 0})
        else:
            trans[f"M{i}"] = observed({"unit_end": n, f"I{i}": 0})
        trans[f"I{i}"] = uniform(nxt)
        trans[f"D{i}"] = uniform(nxt)
    return trans, emissions


def flank_profile(flank: str, error_rate: float, suffix: bool):
    """The flank matchers' transitions: insert 2/5 and delete 1/5 of the
    error rate; the suffix matcher is entered at every match, the prefix
    matcher leaves early from every match with 0.01."""
    F = len(flank)
    ie, de = error_rate * 2 / 5, error_rate / 5
    t = {}
    if suffix:
        t["unit_start"] = {f"M{i}": (1 - ie - de) / F for i in range(1, F + 1)}
        t["unit_start"].update({"D1": de, "I0": ie})
    else:
        t["unit_start"] = {"M1": 1 - ie - de, "D1": de, "I0": ie}
    t["I0"] = {"I0": ie, "D1": de, "M1": 1 - ie - de}
    for i in range(1, F + 1):
        for s in ("I", "M", "D"):
            t[f"{s}{i}"] = {f"I{i}": ie}
            if i == F:
                t[f"{s}{i}"]["unit_end"] = 1 - ie
            elif s == "M" and not suffix:
                t[f"{s}{i}"].update({f"M{i + 1}": 1 - ie - de - 0.01,
                                     f"D{i + 1}": de, "unit_end": 0.01})
            else:
                t[f"{s}{i}"].update({f"M{i + 1}": 1 - ie - de,
                                     f"D{i + 1}": de})
    return t


def _block(g: Graph, W: int, trans: dict, match_emission, region: int,
           unit: int, start: int, tag: str, consensus=None) -> dict:
    """One profile block: inserts I0..IW, matches M1..MW, deletes D1..DW,
    its entry ``start`` (given) and a new exit; every nonzero transition
    of ``trans`` becomes an edge."""
    ids = {"unit_start": start}
    for i in range(W + 1):
        ids[f"I{i}"] = g.add(State(f"I{i}_{tag}", (0.25,) * 4, INSERT,
                                   region, unit))
    for i in range(1, W + 1):
        ids[f"M{i}"] = g.add(State(
            f"M{i}_{tag}", match_emission(i), MATCH, region, unit,
            consensus[i - 1] if consensus is not None else -1))
    for i in range(1, W + 1):
        ids[f"D{i}"] = g.add(State(f"D{i}_{tag}", None, DELETE, region, unit))
    ids["unit_end"] = g.add(State(f"unit_end_{tag}", None, SILENT, region,
                                  unit, unit_end=region == REPEAT))
    for src, row in trans.items():
        for dst, p in row.items():
            g.edge(ids[src], ids[dst], p)
    return ids


def read_matcher(left: str, right: str, segments: list[str], copies: int,
                 error_rate: float) -> tuple[Graph, int, int]:
    """The locus's graph, its start state and its end state."""
    g = Graph()
    start = g.add(State("start", None))
    end = g.add(State("end", None))
    code = {b: i for i, b in enumerate(ACGT)}

    def flank_emission(flank):
        return lambda i: tuple(0.97 if b == flank[i - 1] else 0.01
                               for b in ACGT)

    s_start = g.add(State("suffix_model_start", None))
    suf_entry = g.add(State("suffix_start", None, region=SUFFIX))
    suf = _block(g, len(left), flank_profile(left, error_rate, True),
                 flank_emission(left), SUFFIX, -1, suf_entry, "suffix",
                 [code[b] for b in left])
    g.edge(start, s_start, 1.0)
    g.edge(s_start, suf_entry, 0.3)
    chain = [g.add(State(n, None)) for n in
             ("suffix_model_end", "repeat_model_start",
              "pattern_model_start", "start_repeats")]
    g.edge(suf["unit_end"], chain[0], 1.0)
    for a, b in zip(chain[:-1], chain[1:]):
        g.edge(a, b, 1.0)

    trans, emis = repeat_profile(segments, error_rate)
    W = len(segments[0])
    units = []
    for c in range(copies):
        us = g.add(State(f"unit_start_{c}", None, region=REPEAT, unit=c,
                         unit_start=True))
        units.append(_block(g, W, trans, lambda i: emis[f"M{i}"], REPEAT, c,
                            us, str(c)))
    g.edge(chain[-1], units[0]["unit_start"], 1.0)
    end_repeats = g.add(State("end_repeats", None))
    for c in range(copies - 1):
        g.edge(units[c]["unit_end"], units[c + 1]["unit_start"], 0.5)
    for c in range(copies):
        g.edge(units[c]["unit_end"], end_repeats, 0.5)
    # (the pattern model's end, fed by the last unit_end and end_repeats,
    # leads nowhere in adVNTR's model; it is left out)
    r_end = g.add(State("repeat_model_end", None))
    p_start = g.add(State("prefix_model_start", None))
    pre_entry = g.add(State("prefix_start", None, region=PREFIX))
    g.edge(end_repeats, r_end, 1.0)
    g.edge(r_end, p_start, 1.0)
    g.edge(p_start, pre_entry, 1.0)
    pre = _block(g, len(right), flank_profile(right, error_rate, False),
                 flank_emission(right), PREFIX, -1, pre_entry, "prefix",
                 [code[b] for b in right])
    p_end = g.add(State("prefix_model_end", None))
    g.edge(pre["unit_end"], p_end, 1.0)
    g.edge(p_end, end, 1.0)

    first = [units[0][f"M{i}"] for i in range(1, W + 1)]
    for m in first:
        g.edge(s_start, m, 0.7 / len(first))
    matches = [u[f"M{i}"] for u in units for i in range(1, W + 1)]
    to_end = 0.7 / len(matches)
    for m in matches:
        for key in [k for k in g.edges if k[0] == m]:
            g.edges[key] /= (1 + to_end)
        g.edge(m, p_end, to_end / (1 + to_end))
    return g, start, end


def locus_graph(locus: dict, read_length: int, error_rate: float,
                copies: int | None = None, flank: int | None = None):
    """The graph adVNTR scores a locus's reads against: Illumina models
    take ``round(read_length / motif + 0.5)`` units and flanks of the read
    length; long-read models pass ``copies`` and ``flank`` (100)."""
    if copies is None:
        copies = int(round(read_length / len(locus["pattern"]) + 0.5))
    flank = read_length if flank is None else flank
    return read_matcher(locus["left"][-flank:], locus["right"][:flank],
                        locus["segments"], copies, error_rate)


@dataclasses.dataclass
class Compiled:
    """The graph as arrays for the decoder: emitting states first, then the
    silent ones in a topological order whose consecutive states are
    mostly joined by an edge (runs of a chain)."""
    n_emit: int
    n: int
    order: np.ndarray            # graph index of each position
    log_emit: np.ndarray         # (n_emit, 4)
    start: int                   # positions
    end: int
    # edges into emitting states, padded per state: (n_emit, K)
    e_src: np.ndarray
    e_w: np.ndarray
    # edges silent <- emitting of the same column
    se_src: np.ndarray
    se_dst: np.ndarray
    se_w: np.ndarray
    # silent <- silent: per silent position, its silent preds
    ss_preds: list
    runs: list                   # [(first, last + 1)] chain runs
    run_w: np.ndarray            # weight of the edge k-1 -> k, per silent
    meta: dict                   # per-position arrays for the statistics
    transitions: int             # live edges of the graph


def _topo_silent(g: Graph, silent: list[int], succ: dict) -> list[int]:
    """Kahn's order over silent->silent edges that follows chains: a
    state whose last silent pred was just placed goes next."""
    indeg = {s: 0 for s in silent}
    for s in silent:
        for t in succ.get(s, ()):
            if t in indeg:
                indeg[t] += 1
    ready = [s for s in silent if indeg[s] == 0][::-1]
    out = []
    while ready:
        s = ready.pop()
        out.append(s)
        for t in reversed(succ.get(s, [])):
            if t in indeg:
                indeg[t] -= 1
                if indeg[t] == 0:
                    ready.append(t)
    if len(out) != len(silent):
        raise ValueError("silent states form a cycle")
    return out


def compile_graph(g: Graph, start: int, end: int) -> Compiled:
    succ, pred = {}, {}
    for (a, b) in g.edges:
        succ.setdefault(a, []).append(b)
        pred.setdefault(b, []).append(a)
    # live states: reachable from start and reaching end
    def reach(src, nbrs):
        seen, stack = {src}, [src]
        while stack:
            for t in nbrs.get(stack.pop(), ()):
                if t not in seen:
                    seen.add(t)
                    stack.append(t)
        return seen
    live = reach(start, succ) & reach(end, pred)
    edges = {k: p for k, p in g.edges.items() if k[0] in live and k[1] in live}
    succ = {}
    for (a, b) in edges:
        succ.setdefault(a, []).append(b)
    emit = [i for i in range(len(g.states))
            if i in live and g.states[i].emission is not None]
    silent = _topo_silent(g, [i for i in range(len(g.states))
                              if i in live and g.states[i].emission is None],
                          succ)
    order = np.array(emit + silent, dtype=np.int64)
    pos = {s: k for k, s in enumerate(order)}
    E, n = len(emit), len(order)
    with np.errstate(divide="ignore"):
        log_emit = np.log(np.array([g.states[s].emission for s in emit],
                                   dtype=np.float64).reshape(E, 4))
    into_emit = [[] for _ in range(E)]
    se = []
    ss = [[] for _ in range(n)]
    for (a, b), p in edges.items():
        pa, pb, w = pos[a], pos[b], math.log(p)
        if pb < E:
            into_emit[pb].append((pa, w))
        elif pa < E:
            se.append((pa, pb, w))
        else:
            ss[pb].append((pa, w))
    K = max(len(x) for x in into_emit)
    e_src = np.zeros((E, K), dtype=np.int64)
    e_w = np.full((E, K), -np.inf)
    for j, lst in enumerate(into_emit):
        for k, (a, w) in enumerate(lst):
            e_src[j, k], e_w[j, k] = a, w
    se = np.array(se, dtype=np.float64).reshape(-1, 3)
    runs, run_w = [], np.zeros(n)
    k = E
    while k < n:
        first = k
        k += 1
        while k < n and len(ss[k]) == 1 and ss[k][0][0] == k - 1:
            run_w[k] = ss[k][0][1]
            k += 1
        runs.append((first, k))
    st = [g.states[s] for s in order]
    meta = {
        "emitting": np.array([k < E for k in range(n)]),
        "kind": np.array([s.kind for s in st]),
        "region": np.array([s.region for s in st]),
        "consensus": np.array([s.consensus for s in st]),
        "unit_start": np.array([s.unit_start for s in st]),
        "unit_end": np.array([s.unit_end for s in st]),
    }
    return Compiled(E, n, order, log_emit, pos[start], pos[end], e_src, e_w,
                    se[:, 0].astype(np.int64), se[:, 1].astype(np.int64),
                    se[:, 2], ss, runs, run_w, meta, len(edges))
