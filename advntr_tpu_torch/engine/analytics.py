"""Viterbi-path analytics: repeat-unit counting, flank statistics, segments.

Operates on expanded visited-state name sequences (the same name scheme as
the reference, which made state names the de-facto kernel/engine contract —
reference hmm_utils.py:106-286).  These host implementations are the
conformance baseline; the device pipeline computes the same quantities
vectorized from compiled-state metadata without strings
(advntr_tpu.engine.device_analytics).
"""

from __future__ import annotations


def is_match_state(name: str) -> bool:
    return name.startswith("M")


def is_emitting_state(name: str) -> bool:
    return (name.startswith("M") or name.startswith("I")
            or name.startswith("start_random_matches")
            or name.startswith("end_random_matches"))


def count_repeats(visited_states: list[str],
                  min_bp_in_repeat: int = 3) -> int:
    """Repeat-unit count from a visited-state sequence.

    Counts unit_start crossings with >= min_bp remaining and unit_end
    crossings with >= min_bp consumed; takes the max and adds one when a
    trailing start and leading end indicate one extra straddled unit
    (reference semantics: hmm_utils.py:155-188).
    """
    read_length = sum(1 for vs in visited_states if is_emitting_state(vs))
    starts = ends = 0
    current_bp = 0
    first_end = last_end = first_start = last_start = None
    for vs in visited_states:
        if is_emitting_state(vs):
            current_bp += 1
        if vs.startswith("unit_start") and read_length - current_bp >= min_bp_in_repeat:
            if first_start is None:
                first_start = current_bp
            last_start = current_bp
            starts += 1
        if vs.startswith("unit_end") and current_bp >= min_bp_in_repeat:
            if first_end is None:
                first_end = current_bp
            last_end = current_bp
            ends += 1
    delta = 0
    if None not in (first_start, last_start, first_end, last_end):
        if first_end < first_start and last_start > last_end:
            delta = 1
    return max(starts, ends) + delta


def count_matches(visited_states: list[str]) -> int:
    return sum(1 for vs in visited_states if is_match_state(vs))


def count_repeat_bp_matches(visited_states: list[str]) -> int:
    """Emitting states inside the repeat section (state names not ending in
    'fix' excludes suffix/prefix flank states)."""
    return sum(1 for vs in visited_states
               if is_emitting_state(vs) and not vs.endswith("fix"))


def left_flank_size(visited_states: list[str]) -> int:
    return sum(1 for vs in visited_states
               if is_emitting_state(vs) and vs.endswith("suffix"))


def right_flank_size(visited_states: list[str]) -> int:
    return sum(1 for vs in visited_states
               if is_emitting_state(vs) and vs.endswith("prefix"))


def flanking_matching_rate(visited_states: list[str], sequence: str,
                           left_flank: str, right_flank: str,
                           accuracy_filter: bool = False) -> float:
    """min(left, right) per-base match rate over flank-region states.

    A flank match-state counts as matching when the emitted base equals the
    flank consensus base at that profile position (reference semantics:
    hmm_utils.py:209-268; the reference resolves the consensus via the
    suffix/prefix pattern index, which is exactly the state's 0.97-base).
    """
    right_matches = right_bps = left_matches = left_bps = 0
    # suffix profile length: the suffix pattern is the last F bases of
    # left_flank where F = the highest suffix profile index in the model;
    # the reference derives it from the state preceding suffix_end (always
    # the last column).  Both reduce to: consensus char of M{i}_suffix is
    # left_flank[-(F - i + 1)].  We recover F from the states seen.
    max_suffix_idx = 0
    for vs in visited_states:
        if vs.endswith("suffix") and (vs[0] in "MID") and "_" in vs:
            try:
                max_suffix_idx = max(max_suffix_idx, int(vs.split("_")[0][1:]))
            except ValueError:
                pass
    # If the path exits through suffix_end, the exit column is always the
    # final one, i.e. F = len(suffix pattern); the suffix pattern is
    # left_flank[-F:], making consensus(M_i) = left_flank[-(F - i + 1)].
    # Using the max seen index is only a lower bound for F when the read ends
    # inside the flank, but in that case the suffix states never appear with
    # higher indices anyway and the rate over visited states is identical.
    suffix_f = None
    for k, vs in enumerate(visited_states):
        if "suffix_end_suffix" in vs:
            prev = visited_states[k - 1] if k else vs
            try:
                suffix_f = int(prev.split("_")[0][1:])
            except (ValueError, IndexError):
                suffix_f = None
            break
    F = suffix_f if suffix_f is not None else max_suffix_idx

    seq_index = 0
    for vs in visited_states:
        if "start" in vs or "end" in vs:
            continue
        if vs.endswith("prefix"):
            idx = int(vs.split("_")[0][1:])
            if is_match_state(vs) and sequence[seq_index] == right_flank[idx - 1]:
                right_matches += 1
            if is_emitting_state(vs):
                right_bps += 1
        if vs.endswith("suffix"):
            idx = int(vs.split("_")[0][1:])
            if is_match_state(vs) and F and \
                    sequence[seq_index] == left_flank[-(F - idx + 1)]:
                left_matches += 1
            if is_emitting_state(vs):
                left_bps += 1
        if is_emitting_state(vs):
            seq_index += 1

    if accuracy_filter:
        eps = 0.00001
        right_rate = right_matches / right_bps if right_bps else eps
        left_rate = left_matches / left_bps if left_bps else eps
    else:
        right_rate = right_matches / right_bps if right_bps else 1
        left_rate = left_matches / left_bps if left_bps else 1
    return min(right_rate, left_rate)


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


def extract_repeating_segments(sequence: str,
                               visited_states: list[str]):
    """Per-unit subsequences and in-unit state paths
    (reference semantics: hmm_utils.py:70-91)."""
    repeats, vpaths = [], []
    prev_start = None
    prev_start_state = None
    seq_index = 0
    for i, vs in enumerate(visited_states):
        if vs.startswith("unit_end") and prev_start is not None:
            repeats.append(sequence[prev_start:seq_index])
            vpaths.append(visited_states[prev_start_state + 1:i])
        if vs.startswith("unit_start"):
            prev_start = seq_index
            prev_start_state = i
        if is_emitting_state(vs):
            seq_index += 1
    return repeats, vpaths


def emitted_base_for_state(state: str, visited_states: list[str],
                           sequence: str):
    """The base emitted at the (first) occurrence of `state` in the path
    (reference semantics: hmm_utils.py:106-113)."""
    bp = 0
    for vs in visited_states:
        if vs == state:
            return sequence[bp]
        if is_emitting_state(vs):
            bp += 1
    return None
