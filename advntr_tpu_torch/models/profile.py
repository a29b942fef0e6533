"""Profile-HMM parameter estimation from a repeat-unit multiple alignment.

Reproduces the estimator semantics of the reference
(advntr/profile_hmm.py:13-161):

- a column with >= 50% gaps is an *insert* column; the remaining columns are
  match columns numbered 1..W
- emissions: per match/insert state, normalized counts with pseudocount
  ``pseu = (n_seqs / 4) * (error_rate / 10)`` added *after* normalizing and
  then renormalized; states with no observations get uniform 1/4
- transitions: per-state counts over consecutive state pairs in each row's
  state path; normalized as ``(count/total + pseu) / (1 + pseu * n_targets)``
  where ``n_targets`` counts the explicitly-present target keys (missing
  canonical targets are injected as zero counts first); states never visited
  get uniform 1/3 (or 1/2 at the last column); the I0 state is never counted
  and therefore always ends up uniform 1/3 over {I0, D1, M1}
- finally every (state, state) pair absent from the table is filled with
  probability 0

The output is a pair of nested dicts keyed by state names
('unit_start', 'I0', 'M1', 'D1', 'I1', ..., 'unit_end') exactly like the
reference, because the model-graph builder consumes that shape.
"""

from __future__ import annotations

ALPHABET = "ACGT"


def profile_from_alignment(error_rate: float, alignment: list[str]):
    """Estimate (transitions, emissions) dicts from aligned repeat units."""
    n_seqs = len(alignment)
    n_cols = len(alignment[0])
    pseu = (n_seqs / 4.0) * (error_rate / 10.0)
    gap_thresh = 0.5 * n_seqs

    insert_cols = set()
    for col in range(n_cols):
        gaps = sum(1 for row in alignment if row[col] == "-")
        if gaps >= gap_thresh:
            insert_cols.add(col)

    n_match = n_cols - len(insert_cols)

    emissions: dict[str, dict[str, float]] = {}
    emissions["unit_start"] = {x: 0 for x in ALPHABET}
    emissions["unit_end"] = {x: 0 for x in ALPHABET}
    emissions["I0"] = {x: 0 for x in ALPHABET}
    for i in range(1, n_match + 1):
        emissions[f"I{i}"] = {x: 0 for x in ALPHABET}
        emissions[f"M{i}"] = {x: 0 for x in ALPHABET}
        emissions[f"D{i}"] = {x: 0 for x in ALPHABET}

    # Per-row state paths; count match/insert emissions along the way.
    state_paths: list[list[str]] = []
    for row in alignment:
        path = []
        match_idx = 1
        for col in range(n_cols):
            if col not in insert_cols:
                if row[col] == "-":
                    path.append(f"D{match_idx}")
                else:
                    path.append(f"M{match_idx}")
                    emissions[f"M{match_idx}"][row[col]] += 1
                match_idx += 1
            elif row[col] != "-":
                path.append(f"I{match_idx - 1}")
                emissions[f"I{match_idx - 1}"][row[col]] += 1
        state_paths.append(path)

    # Normalize emissions with the reference's add-after-normalize pseudocount.
    for key, table in emissions.items():
        if key in ("unit_start", "unit_end") or key.startswith("D"):
            continue
        total = sum(table.values())
        if total > 0:
            # plain left-fold accumulation, NOT builtin sum(): CPython >=3.12
            # sum() is Neumaier-compensated for floats, which flips the last
            # ulp vs the reference's loop (profile_hmm.py:61-68) and breaks
            # bit-level emission conformance
            sub_total = 0.0
            for base in table:
                table[base] = table[base] / total + pseu
                sub_total += table[base]
            for base in table:
                table[base] = table[base] / sub_total
        else:
            for base in table:
                table[base] = 1.0 / len(ALPHABET)

    # Transition counts.
    transitions: dict[str, dict[str, float]] = {}
    transitions["unit_start"] = {"I0": 0, "D1": 0, "M1": 0}
    for path in state_paths:
        transitions["unit_start"][path[0]] += 1
    # I0 is intentionally never counted (reference: profile_hmm.py:83-84),
    # so it always normalizes to uniform 1/3.
    transitions["I0"] = {"I0": 0, "D1": 0, "M1": 0}

    for path in state_paths:
        for j in range(len(path) - 1):
            transitions.setdefault(path[j], {}).setdefault(path[j + 1], 0)
            transitions[path[j]][path[j + 1]] += 1
        transitions.setdefault(path[-1], {}).setdefault("unit_end", 0)
        transitions[path[-1]]["unit_end"] += 1

    # Make sure last-column states and every canonical state key exist.
    for prefix in ("I", "D", "M"):
        last = f"{prefix}{n_match}"
        transitions.setdefault(last, {}).setdefault("unit_end", 0)
    for i in range(1, n_match + 1):
        for prefix in ("I", "M", "D"):
            transitions.setdefault(f"{prefix}{i}", {})

    # Normalize transitions.
    for key, table in transitions.items():
        if key == "unit_end":
            continue
        total = sum(table.values())
        if key not in ("unit_start", "I0"):
            idx = key[1:]
            if idx != str(n_match):
                table.setdefault("I" + idx, 0)
                table.setdefault("D" + str(int(idx) + 1), 0)
                table.setdefault("M" + str(int(idx) + 1), 0)
            else:
                table.setdefault("I" + idx, 0)
                table.setdefault("unit_end", 0)
        n_targets = len(table)
        for sub_key in table:
            if total > 0:
                p = table[sub_key] / total
                table[sub_key] = (p + pseu) / (1 + pseu * n_targets)
            else:
                if n_targets == 3:
                    table[sub_key] = 1.0 / 3
                elif n_targets == 2:
                    table[sub_key] = 1.0 / 2

    # Fill every absent (state, state) pair with 0.
    index_list = ["unit_start", "I0"]
    for i in range(1, n_match + 1):
        index_list.extend([f"M{i}", f"D{i}", f"I{i}"])
    index_list.append("unit_end")
    for key1 in index_list:
        transitions.setdefault(key1, {})
        for key2 in index_list:
            transitions[key1].setdefault(key2, 0)

    return transitions, emissions


def read_alignment_fasta(path: str) -> list[str]:
    """Read a precomputed MSA from aligned FASTA (MUSCLE's output format:
    '-' gaps, equal-length rows).  Used by the alignment-import conformance
    mode (reference runs MUSCLE and parses it via AlignIO,
    profile_hmm.py:165-171)."""
    rows, cur = [], []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                if cur:
                    rows.append("".join(cur))
                cur = []
            else:
                cur.append(line.upper())
    if cur:
        rows.append("".join(cur))
    if not rows:
        raise ValueError(f"no sequences in alignment file {path}")
    if len({len(r) for r in rows}) != 1:
        raise ValueError(f"alignment rows have unequal lengths in {path}")
    return rows


def profile_for_repeats(repeats: list[str], error_rate: float,
                        aligner=None, alignment=None):
    """Estimate a profile from raw (unaligned) repeat segments.

    The reference shells out to MUSCLE for the MSA (profile_hmm.py:165-171);
    here the default aligner is the internal center-star MSA
    (advntr_tpu.models.msa), which needs no external binary.

    ``alignment`` imports a precomputed MSA instead of aligning: a list of
    equal-length gapped rows, or a path to an aligned FASTA (e.g. MUSCLE
    output).  This is the conformance mode for pre-trained-DB loci whose
    emissions were estimated from a MUSCLE alignment — with the recorded
    alignment the estimator reproduces the reference's parameters at the
    bit level (tests/test_profile_import.py).
    """
    if alignment is not None:
        if isinstance(alignment, str):
            alignment = read_alignment_fasta(alignment)
        return profile_from_alignment(error_rate, list(alignment))
    if len(repeats) > 1:
        if aligner is None:
            from advntr_tpu_torch.models.msa import center_star_msa
            aligner = center_star_msa
        aligned = aligner(repeats)
    else:
        aligned = list(repeats)
    return profile_from_alignment(error_rate, aligned)
