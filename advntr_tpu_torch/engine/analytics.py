"""Viterbi-path analytics on visited-state names: the part of
advntr_tpu/engine/analytics.py that the repeat finder of
``models/reference_vntr.py`` needs (per-unit segment lengths of a decoded
reference region).  The per-read statistics of the genotype path are
computed on the device (``engine/device_analytics.py``).
"""

from __future__ import annotations


def is_emitting_state(name: str) -> bool:
    return (name.startswith("M") or name.startswith("I")
            or name.startswith("start_random_matches")
            or name.startswith("end_random_matches"))


def repeating_pattern_lengths(visited_states: list[str]) -> list[int]:
    """Observed length (emitted bp) of each complete repeat unit
    (reference semantics: hmm_utils.py:129-141)."""
    lengths = []
    prev_start = None
    for i, vs in enumerate(visited_states):
        if vs.startswith("unit_end") and prev_start is not None:
            lengths.append(sum(1 for j in range(prev_start, i)
                               if is_emitting_state(visited_states[j])))
        if vs.startswith("unit_start"):
            prev_start = i
    return lengths


def repeat_segments_from_region(visited_states: list[str],
                                region: str) -> list[str]:
    """Split a reference region into per-unit segments using a decoded path
    (reference semantics: hmm_utils.py:144-152)."""
    lengths = repeating_pattern_lengths(visited_states)
    segments = []
    added = 0
    for ln in lengths:
        segments.append(region[added:added + ln])
        added += ln
    return segments
