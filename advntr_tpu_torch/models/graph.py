"""HMM graph construction: the *effective* read-matcher topology.

The reference builds its read-matcher HMM in several passes (sub-model
builders + pomegranate `concatenate` + two `from_matrix` round-trips with
dense-matrix surgery, advntr/hmm_utils.py:290-595).  Because every pass runs
with ``merge=None`` (no normalization, no pruning), the net result is a fixed
effective graph which this module constructs directly, in one pass, with
reference-identical state names.  Notable quirks reproduced on purpose:

- ``Model.from_matrix`` connects the *last listed state* (not the flagged end
  state) to the new model end (pomegranate/hmm.pyx:3231-3235 uses the stale
  loop variable ``states[j]``).  In the repeats matcher the last listed state
  is ``end_repeating_pattern_match``; in the final read matcher the
  topologically-last silent state is ``Prefix Matcher HMM Model-end`` (visible
  in the recorded Viterbi path fixture, reference tests/data/hmm_utils.json).
  The effective routes are end_repeating_pattern_match -> Repeat Matcher end
  and prefix_end -> Read Matcher end, which is what we build.
- ``Repeating Pattern Matcher HMM Model-end`` is kept as a dead-end silent
  state: 0.5 of each final unit_end's mass and 1.0 "mass" out of
  end_repeating_pattern_match flow into it and are lost (the weights are used
  unnormalized, hmm.pyx:765 with merge=None skips normalization).  Dead ends
  never appear on a Viterbi path, so the compiler drops them naturally.
- repeat match states renormalize their out-edges to make room for a direct
  exit edge of mass ``0.7/n_repeat_match_states`` (hmm_utils.py:578-584); the
  model start sends 0.3 to the left-flank matcher and 0.7 split over the
  first-copy match states (hmm_utils.py:574-576).

State-name scheme (the de-facto contract consumed by the path analytics,
reference hmm_utils.py:116-127): ``M{i}_{suffix|prefix|copy}``,
``I{i}_...``, ``D{i}_...``, ``unit_start_{c}``, ``unit_end_{c}``,
``suffix_start_suffix``, ``prefix_end_prefix``, ...
"""

from __future__ import annotations

import dataclasses


# state kinds
K_MATCH, K_INSERT, K_DELETE, K_OTHER = 0, 1, 2, 3
# regions
R_SUFFIX, R_REPEAT, R_PREFIX, R_OTHER = 0, 1, 2, 3

UNIFORM = {b: 0.25 for b in "ACGT"}


def consensus_emission(base: str) -> dict[str, float]:
    table = {b: 0.01 for b in "ACGT"}
    table[base] = 0.97
    return table


@dataclasses.dataclass
class StateDef:
    name: str
    emission: dict[str, float] | None = None  # None => silent
    kind: int = K_OTHER
    region: int = R_OTHER
    pos: int = 0       # profile column (1-based for M/D, 0-based for I)
    unit: int = -1     # repeat-copy index

    @property
    def is_silent(self) -> bool:
        return self.emission is None


class HmmGraph:
    """Simple probability-space directed graph with one START and one END."""

    def __init__(self, name: str = "model"):
        self.name = name
        self.states: list[StateDef] = []
        self._index: dict[str, int] = {}
        self.edges: dict[tuple[int, int], float] = {}
        self.start = self.add(StateDef(f"{name}-start"))
        self.end = self.add(StateDef(f"{name}-end"))

    def add(self, state: StateDef) -> int:
        if state.name in self._index:
            raise ValueError(f"duplicate state {state.name}")
        self._index[state.name] = len(self.states)
        self.states.append(state)
        return len(self.states) - 1

    def idx(self, name: str) -> int:
        return self._index[name]

    def set_edge(self, src: int, dst: int, prob: float) -> None:
        if prob != 0.0:
            self.edges[(src, dst)] = float(prob)
        else:
            self.edges.pop((src, dst), None)

    def scale_out_edges(self, src: int, factor: float) -> None:
        for (a, b) in list(self.edges):
            if a == src:
                self.edges[(a, b)] *= factor

    def out_edges(self, src: int):
        return [(b, p) for (a, b), p in self.edges.items() if a == src]


def _add_profile_block(g: HmmGraph, *, n_match: int, suffix: str, region: int,
                       unit: int, start_name: str, end_name: str,
                       match_emissions, insert_emissions, trans,
                       start_idx: int | None = None) -> dict:
    """Add one profile-HMM block (inserts I0..IW, matches M1..MW, deletes
    D1..DW, plus the block's silent start/end) and its internal edges.

    ``trans`` maps canonical labels ('unit_start','I0','M1','D1',...) to
    {target_label: prob}; every (source, target) pair present in the table
    becomes an edge, so flank variants (entry at all match positions,
    early exit to unit_end) are expressed purely in the table.
    Zero-probability entries yield no edge (from_matrix drops exact zeros,
    pomegranate/hmm.pyx:3228-3230).

    If ``start_idx`` is given, that existing silent state is used as the
    block entry instead of creating one (used for unit_start_{c} states).
    """
    ins = [g.add(StateDef(f"I{i}_{suffix}", insert_emissions(i), K_INSERT,
                          region, i, unit)) for i in range(n_match + 1)]
    mat = [g.add(StateDef(f"M{i}_{suffix}", match_emissions(i), K_MATCH,
                          region, i, unit)) for i in range(1, n_match + 1)]
    dele = [g.add(StateDef(f"D{i}_{suffix}", None, K_DELETE, region, i, unit))
            for i in range(1, n_match + 1)]
    if start_idx is None:
        block_start = g.add(StateDef(start_name, None, K_OTHER, region, 0, unit))
    else:
        block_start = start_idx
    block_end = g.add(StateDef(end_name, None, K_OTHER, region, n_match + 1, unit))

    def resolve(label: str) -> int:
        if label == "unit_start":
            return block_start
        if label == "unit_end":
            return block_end
        kind, idx = label[0], int(label[1:])
        if kind == "M":
            return mat[idx - 1]
        if kind == "D":
            return dele[idx - 1]
        return ins[idx]

    for src_label, row in trans.items():
        if src_label == "unit_end":
            continue
        src = resolve(src_label)
        for dst_label, p in row.items():
            g.set_edge(src, resolve(dst_label), p)

    return {"ins": ins, "mat": mat, "del": dele,
            "start": block_start, "end": block_end}


def _flank_transitions(pattern: str, error_rate: float, *,
                       entry_at_all_matches: bool, early_exit: bool) -> dict:
    """Transition table for a flank matcher (suffix/prefix variants).

    Suffix matcher: entry mass spread over every match position
    (hmm_utils.py:388-389) so a read may begin mid-flank.  Prefix matcher:
    entry only at M1 but matches may exit early to unit_end with 0.01
    (hmm_utils.py:344-346) so a read may end mid-flank.
    """
    F = len(pattern)
    ie = error_rate * 2 / 5
    de = error_rate * 1 / 5
    t: dict[str, dict[str, float]] = {}
    if entry_at_all_matches:
        t["unit_start"] = {f"M{i}": (1 - ie - de) / F for i in range(1, F + 1)}
        t["unit_start"].update({"D1": de, "I0": ie})
    else:
        t["unit_start"] = {"M1": 1 - ie - de, "D1": de, "I0": ie}
    t["I0"] = {"I0": ie, "D1": de, "M1": 1 - ie - de}
    for i in range(1, F + 1):
        t[f"I{i}"] = {f"I{i}": ie}
        t[f"M{i}"] = {f"I{i}": ie}
        t[f"D{i}"] = {f"I{i}": ie}
        if i < F:
            t[f"I{i}"].update({f"M{i + 1}": 1 - ie - de, f"D{i + 1}": de})
            if early_exit:
                t[f"M{i}"].update({f"M{i + 1}": 1 - ie - de - 0.01,
                                   f"D{i + 1}": de, "unit_end": 0.01})
            else:
                t[f"M{i}"].update({f"M{i + 1}": 1 - ie - de, f"D{i + 1}": de})
            t[f"D{i}"].update({f"M{i + 1}": 1 - ie - de, f"D{i + 1}": de})
        else:
            t[f"M{i}"]["unit_end"] = 1 - ie
            t[f"D{i}"]["unit_end"] = 1 - ie
            t[f"I{i}"]["unit_end"] = 1 - ie
    return t


def build_read_matcher(left_flank: str, right_flank: str,
                       repeat_transitions: dict, repeat_emissions: dict,
                       copies: int, error_rate: float) -> HmmGraph:
    """Construct the full effective read-matcher graph (silent states kept).

    Equivalent capability: reference get_read_matcher_model
    (hmm_utils.py:553-595) including the concatenation silent chain and the
    two from_matrix round-trips.
    """
    g = HmmGraph("Read Matcher")

    # ---- left flank (suffix matcher) -------------------------------------
    Fs = len(left_flank)
    suf_trans = _flank_transitions(left_flank, error_rate,
                                   entry_at_all_matches=True, early_exit=False)
    suf = _add_profile_block(
        g, n_match=Fs, suffix="suffix", region=R_SUFFIX, unit=-1,
        start_name="suffix_start_suffix", end_name="suffix_end_suffix",
        match_emissions=lambda i: consensus_emission(left_flank[i - 1]),
        insert_emissions=lambda i: dict(UNIFORM), trans=suf_trans)
    suffix_model_start = g.add(StateDef("Suffix Matcher HMM Model-start"))
    suffix_model_end = g.add(StateDef("Suffix Matcher HMM Model-end"))
    g.set_edge(g.start, suffix_model_start, 1.0)
    # start surgery (hmm_utils.py:574-576): 0.3 into the flank matcher ...
    g.set_edge(suffix_model_start, suf["start"], 0.3)
    g.set_edge(suf["end"], suffix_model_end, 1.0)

    # ---- repeats section --------------------------------------------------
    matches = [k for k in repeat_emissions if k.startswith("M")]
    W = len(matches)
    rep_model_start = g.add(StateDef("Repeat Matcher HMM Model-start"))
    rep_model_end = g.add(StateDef("Repeat Matcher HMM Model-end"))
    pat_model_start = g.add(StateDef("Repeating Pattern Matcher HMM Model-start"))
    pat_model_end = g.add(StateDef("Repeating Pattern Matcher HMM Model-end"))
    start_repeats = g.add(StateDef("start_repeating_pattern_match"))
    end_repeats = g.add(StateDef("end_repeating_pattern_match"))

    g.set_edge(suffix_model_end, rep_model_start, 1.0)
    g.set_edge(rep_model_start, pat_model_start, 1.0)
    g.set_edge(pat_model_start, start_repeats, 1.0)

    unit_blocks = []
    for c in range(copies):
        unit_start = g.add(StateDef(f"unit_start_{c}", None, K_OTHER, R_REPEAT,
                                    0, c))
        blk = _add_profile_block(
            g, n_match=W, suffix=str(c), region=R_REPEAT, unit=c,
            start_name=f"unit_start_{c}", end_name=f"unit_end_{c}",
            match_emissions=lambda i: dict(repeat_emissions[f"M{i}"]),
            insert_emissions=lambda i: dict(repeat_emissions[f"I{i}"]),
            trans=repeat_transitions, start_idx=unit_start)
        unit_blocks.append(blk)

    g.set_edge(start_repeats, unit_blocks[0]["start"], 1.0)
    for c in range(copies):
        unit_end = unit_blocks[c]["end"]
        # variable-number surgery (hmm_utils.py:530-536): each unit_end keeps
        # 0.5 on its original next hop and sends 0.5 to end_repeats
        if c < copies - 1:
            g.set_edge(unit_end, unit_blocks[c + 1]["start"], 0.5)
        else:
            g.set_edge(unit_end, pat_model_end, 0.5)  # dead end, kept
        g.set_edge(unit_end, end_repeats, 0.5)
    g.set_edge(end_repeats, pat_model_end, 1.0)      # dead end, kept
    g.set_edge(end_repeats, rep_model_end, 1.0)      # from_matrix quirk route

    # ---- right flank (prefix matcher) ------------------------------------
    Fp = len(right_flank)
    pre_trans = _flank_transitions(right_flank, error_rate,
                                   entry_at_all_matches=False, early_exit=True)
    pre = _add_profile_block(
        g, n_match=Fp, suffix="prefix", region=R_PREFIX, unit=-1,
        start_name="prefix_start_prefix", end_name="prefix_end_prefix",
        match_emissions=lambda i: consensus_emission(right_flank[i - 1]),
        insert_emissions=lambda i: dict(UNIFORM), trans=pre_trans)
    prefix_model_start = g.add(StateDef("Prefix Matcher HMM Model-start"))
    prefix_model_end = g.add(StateDef("Prefix Matcher HMM Model-end"))
    g.set_edge(rep_model_end, prefix_model_start, 1.0)
    g.set_edge(prefix_model_start, pre["start"], 1.0)
    g.set_edge(pre["end"], prefix_model_end, 1.0)
    g.set_edge(prefix_model_end, g.end, 1.0)  # final from_matrix quirk route

    # ---- read-start / read-end shortcut surgery ---------------------------
    # start -> every first-copy match state, mass 0.7/|M*_0|
    first_matches = unit_blocks[0]["mat"]
    for m in first_matches:
        g.set_edge(suffix_model_start, m, 0.7 / len(first_matches))
    # every repeat match state: renormalize out-edges, add exit edge
    all_repeat_matches = [m for blk in unit_blocks for m in blk["mat"]]
    to_end = 0.7 / len(all_repeat_matches)
    for m in all_repeat_matches:
        g.scale_out_edges(m, 1.0 / (1 + to_end))
        g.set_edge(m, prefix_model_end, to_end / (1 + to_end))

    return g


def build_repeat_finder(pattern: str, copies: int) -> HmmGraph:
    """Reference-region repeat decomposition HMM.

    Equivalent capability: reference build_reference_repeat_finder_hmm
    (hmm_utils.py:598-680): per-copy consensus profile blocks with fixed
    0.98/0.01 transitions, free-emitting start/end_random_matches states, and
    0.5/0.5 routing at unit boundaries.  The reference bakes this model with
    merge='All', but all out-masses already sum to 1 and no prob-1 silent
    edges exist, so normalization/merging are no-ops.
    """
    g = HmmGraph("HMM Model")
    start_rand = g.add(StateDef("start_random_matches", dict(UNIFORM),
                                K_OTHER, R_OTHER))
    end_rand = g.add(StateDef("end_random_matches", dict(UNIFORM),
                              K_OTHER, R_OTHER))
    P = len(pattern)
    trans: dict[str, dict[str, float]] = {
        "unit_start": {"M1": 0.98, "D1": 0.01, "I0": 0.01},
        "I0": {"I0": 0.01, "D1": 0.01, "M1": 0.98},
    }
    for i in range(1, P + 1):
        trans[f"I{i}"] = {f"I{i}": 0.01}
        trans[f"M{i}"] = {f"I{i}": 0.01}
        trans[f"D{i}"] = {f"I{i}": 0.01}
        if i < P:
            trans[f"I{i}"].update({f"M{i + 1}": 0.98, f"D{i + 1}": 0.01})
            trans[f"M{i}"].update({f"M{i + 1}": 0.98, f"D{i + 1}": 0.01})
            trans[f"D{i}"].update({f"M{i + 1}": 0.98, f"D{i + 1}": 0.01})
        else:
            trans[f"I{i}"]["unit_end"] = 0.99
            trans[f"M{i}"]["unit_end"] = 0.99
            trans[f"D{i}"]["unit_end"] = 0.99

    blocks = []
    for c in range(copies):
        unit_start = g.add(StateDef(f"unit_start_{c}", None, K_OTHER,
                                    R_REPEAT, 0, c))
        blk = _add_profile_block(
            g, n_match=P, suffix=str(c), region=R_REPEAT, unit=c,
            start_name=f"unit_start_{c}", end_name=f"unit_end_{c}",
            match_emissions=lambda i: consensus_emission(pattern[i - 1]),
            insert_emissions=lambda i: dict(UNIFORM), trans=trans,
            start_idx=unit_start)
        blocks.append(blk)

    g.set_edge(g.start, blocks[0]["start"], 0.5)
    g.set_edge(g.start, start_rand, 0.5)
    g.set_edge(start_rand, blocks[0]["start"], 0.5)
    g.set_edge(start_rand, start_rand, 0.5)
    for c in range(copies):
        g.set_edge(blocks[c]["end"], end_rand, 0.5)
        if c < copies - 1:
            g.set_edge(blocks[c]["end"], blocks[c + 1]["start"], 0.5)
        else:
            g.set_edge(blocks[c]["end"], g.end, 0.5)
    g.set_edge(end_rand, end_rand, 0.5)
    g.set_edge(end_rand, g.end, 0.5)
    return g
