"""Pomegranate trained-HMM JSON interchange.

The reference's model-checkpoint format is pomegranate's HMM JSON
(reference pomegranate/hmm.pyx:3023-3145 to_json/from_json), consumed at
vntr_finder.py:117-138 when USE_TRAINED_HMMS is on: per-(locus,
read-length) files ``<TRAINED_HMMS_DIR>/<vid>_<readlen>.json``.  This
module reads that format into an :class:`HmmGraph` — so existing trained
model caches keep working against the TPU engine — and writes it back out,
which both round-trip-tests the importer without pomegranate and lets
models trained here feed tooling that expects the reference format.

State metadata (kind/region/pos/unit — what the device analytics keys on)
is reconstructed from the reference's state-name grammar:
``{M|I|D}{pos}_{suffix|prefix|unit}``, ``unit_start_{c}``/``unit_end_{c}``
(hmm_utils.py naming, the de-facto kernel/engine contract per SURVEY §2).
"""

from __future__ import annotations

import json
import re

from advntr_tpu_torch.models.graph import (HmmGraph, StateDef, K_DELETE,
                                     K_INSERT, K_MATCH, K_OTHER, R_OTHER,
                                     R_PREFIX, R_REPEAT, R_SUFFIX)

_EMIT_RE = re.compile(r"^([MID])(\d+)_(\d+|suffix|prefix)$")
_UNIT_SILENT_RE = re.compile(r"^unit_(start|end)_(\d+)$")
_FLANK_SILENT_RE = re.compile(r"^(suffix|prefix)_(start|end)_\1$")


def _region_unit(tag: str) -> tuple[int, int]:
    if tag == "suffix":
        return R_SUFFIX, -1
    if tag == "prefix":
        return R_PREFIX, -1
    return R_REPEAT, int(tag)


def _state_def(name: str, emission) -> StateDef:
    m = _EMIT_RE.match(name)
    if m:
        kind = {"M": K_MATCH, "I": K_INSERT, "D": K_DELETE}[m.group(1)]
        region, unit = _region_unit(m.group(3))
        return StateDef(name, emission, kind, region, int(m.group(2)), unit)
    m = _UNIT_SILENT_RE.match(name)
    if m:
        return StateDef(name, emission, K_OTHER, R_REPEAT, 0,
                        int(m.group(2)))
    m = _FLANK_SILENT_RE.match(name)
    if m:
        region = R_SUFFIX if m.group(1) == "suffix" else R_PREFIX
        return StateDef(name, emission, K_OTHER, region, 0, -1)
    return StateDef(name, emission, K_OTHER, R_OTHER, 0, -1)


def graph_from_pomegranate_json(data) -> HmmGraph:
    """Build an HmmGraph from a pomegranate HiddenMarkovModel JSON dict or
    string.  Edge probabilities are taken in probability space, matching
    dense_transition_matrix semantics (hmm.pyx:492-514)."""
    if isinstance(data, (str, bytes)):
        data = json.loads(data)
    if data.get("class") != "HiddenMarkovModel":
        raise ValueError("not a pomegranate HiddenMarkovModel JSON")
    states = data["states"]
    start_i = data["start_index"]
    end_i = data["end_index"]
    g = HmmGraph(data.get("name", "model"))
    idx_map: dict[int, int] = {start_i: g.start, end_i: g.end}
    # keep the model's own start/end names for analytics-visible paths
    g.states[g.start].name = states[start_i]["name"]
    g.states[g.end].name = states[end_i]["name"]
    g._index = {s.name: i for i, s in enumerate(g.states)}
    for i, st in enumerate(states):
        if i in idx_map:
            continue
        dist = st.get("distribution")
        emission = None
        if dist is not None:
            params = dist["parameters"][0]
            emission = {str(k): float(v) for k, v in params.items()}
        idx_map[i] = g.add(_state_def(st["name"], emission))
    # unit_end pos = n_match + 1 (block-end convention, graph.py:131)
    max_pos: dict[int, int] = {}
    for s in g.states:
        if s.region == R_REPEAT and s.kind == K_MATCH:
            max_pos[s.unit] = max(max_pos.get(s.unit, 0), s.pos)
    for s in g.states:
        if s.name.startswith("unit_end_") and s.unit in max_pos:
            s.pos = max_pos[s.unit] + 1
    for edge in data["edges"]:
        src, dst, prob = edge[0], edge[1], float(edge[2])
        g.set_edge(idx_map[src], idx_map[dst], prob)
    return g


def load_trained_hmm(path: str) -> HmmGraph:
    with open(path) as fh:
        return graph_from_pomegranate_json(fh.read())


def graph_to_pomegranate_json(g: HmmGraph) -> str:
    """Serialize an HmmGraph in pomegranate HMM JSON (the reference's
    checkpoint format, hmm.pyx:3023-3096)."""

    def state_dict(s: StateDef):
        dist = None
        if s.emission is not None:
            dist = {
                "class": "Distribution",
                "name": "DiscreteDistribution",
                "parameters": [{k: float(v) for k, v in s.emission.items()}],
                "frozen": False,
            }
        return {"class": "State", "distribution": dist, "name": s.name,
                "weight": 1.0}

    edges = [[src, dst, float(p), 0.0, None]
             for (src, dst), p in sorted(g.edges.items())]
    doc = {
        "class": "HiddenMarkovModel",
        "name": g.name,
        "start": state_dict(g.states[g.start]),
        "end": state_dict(g.states[g.end]),
        "start_index": g.start,
        "end_index": g.end,
        "silent_index": sum(1 for s in g.states if not s.is_silent),
        "states": [state_dict(s) for s in g.states],
        "edges": edges,
        "distribution ties": [],
    }
    return json.dumps(doc)


def save_trained_hmm(g: HmmGraph, path: str) -> None:
    with open(path, "w") as fh:
        fh.write(graph_to_pomegranate_json(g))
