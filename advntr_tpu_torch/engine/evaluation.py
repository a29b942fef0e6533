"""Evaluation and reporting utilities (offline analysis).

Capability-equivalent to the analysis side of the reference's
advntr/plot.py + pairwise_aln_generator.py: genotype-accuracy comparison
against truth sets, recruitment precision/recall bookkeeping, and human-
readable pairwise alignment reports of decoded repeat units against their
consensus (for debugging locus models).
"""

from __future__ import annotations

import dataclasses
from collections import Counter


@dataclasses.dataclass
class GenotypeComparison:
    n_loci: int
    correct: int
    incorrect: int
    missing: int
    errors: int
    mismatches: list

    @property
    def accuracy(self) -> float:
        return self.correct / self.n_loci if self.n_loci else 0.0


def compare_genotypes(called: dict, truth: dict) -> GenotypeComparison:
    """called/truth: {vid: (a, b) or None}; order-insensitive comparison."""
    correct = incorrect = missing = errors = 0
    mismatches = []
    for vid, want in truth.items():
        got = called.get(vid)
        if got == "Error":
            errors += 1
            mismatches.append((vid, want, got))
        elif got is None:
            missing += 1
            mismatches.append((vid, want, None))
        elif tuple(sorted(got)) == tuple(sorted(want)):
            correct += 1
        else:
            incorrect += 1
            mismatches.append((vid, want, got))
    return GenotypeComparison(len(truth), correct, incorrect, missing,
                              errors, mismatches)


def recruitment_metrics(selected_names, true_names, all_names):
    """Precision/recall of read recruitment vs a truth set
    (the comparison the reference runs against BLAST/bowtie2 recruiters,
    deep_recruitment.py:148-263)."""
    selected = set(selected_names)
    true = set(true_names)
    tp = len(selected & true)
    fp = len(selected - true)
    fn = len(true - selected)
    precision = tp / (tp + fp) if tp + fp else 1.0
    recall = tp / (tp + fn) if tp + fn else 1.0
    return {"tp": tp, "fp": fp, "fn": fn,
            "precision": precision, "recall": recall}


def compare_recruitment_methods(ref_vntr, methods: dict, n_true: int = 100,
                                read_length: int = 150,
                                error_rate: float = 0.003,
                                decoys: list[str] | None = None,
                                seed: int = 0):
    """Benchmark recruiter callables on simulated reads for one locus.

    The comparison harness the reference runs against BLAST/bowtie2/DNN
    recruiters over simulated data (deep_recruitment.py:148-263,354-382),
    as a programmatic utility: ``methods`` maps a name to a callable
    ``(reads: list[str]) -> selected indices/bools``; true reads are
    sliding windows over the locus haplotype with errors, decoys default
    to shuffled flank sequence.

    Returns {method: {"tp", "fp", "fn", "precision", "recall"}}.
    """
    import random as _random
    from advntr_tpu_torch.engine.simulate import haplotype_sequence, mutate
    rng = _random.Random(seed)
    copies = len(ref_vntr.get_repeat_segments())
    hap = haplotype_sequence(ref_vntr.left_flanking_region,
                             ref_vntr.pattern, copies,
                             ref_vntr.right_flanking_region)
    true_reads = []
    lo = max(0, len(ref_vntr.left_flanking_region) - read_length + 4)
    hi = max(lo + 1, len(hap) - read_length
             - max(0, len(ref_vntr.right_flanking_region) - read_length + 4))
    for _ in range(n_true):
        start = rng.randint(lo, hi)
        true_reads.append(mutate(hap[start:start + read_length],
                                 error_rate, rng))
    if decoys is None:
        decoys = ["".join(rng.choice("ACGT") for _ in range(read_length))
                  for _ in range(n_true)]
    reads = true_reads + list(decoys)
    true_idx = set(range(len(true_reads)))
    out = {}
    for name, recruit in methods.items():
        sel = recruit(reads)
        if sel and isinstance(next(iter(sel), None), (bool,)) \
                or (hasattr(sel, "dtype") and getattr(sel, "dtype", None)
                    is not None and str(sel.dtype) == "bool"):
            sel_idx = {i for i, keep in enumerate(sel) if keep}
        else:
            sel_idx = set(int(i) for i in sel)
        out[name] = recruitment_metrics(sel_idx, true_idx,
                                        range(len(reads)))
    return out


def mutated_reference_sweep(ref_vntr, chromosome_seq: str, desired_counts,
                            coverage: int = 30, read_length: int = 150,
                            error_rate: float = 0.003,
                            flank: int | None = None, config=None,
                            seed: int = 0, finder=None):
    """End-to-end validation loop: edit the reference's repeat count →
    simulate reads from the edited haplotype → genotype with the ORIGINAL
    locus model → compare against the edited truth.

    This is the reference's mutated-reference validation workflow
    (advntr/reference_editor.py:66-97 builds the edited FASTAs whose
    simulated datasets feed plot.py-style accuracy sweeps) connected into
    one programmatic utility.  Returns {"rows": [...], "comparison":
    GenotypeComparison} where each row records the desired count, the
    called genotype and the evidence counts.
    """
    import random as _random
    from advntr_tpu_torch.config import Config
    from advntr_tpu_torch.engine.finder import VNTRFinder
    from advntr_tpu_torch.engine.reference_editor import reference_with_repeat_count
    from advntr_tpu_torch.engine.simulate import mutate
    rng = _random.Random(seed)
    if flank is None:
        flank = max(read_length + 20, 200)
    if finder is None:
        finder = VNTRFinder(ref_vntr, config or Config())
    called, truth, rows = {}, {}, []
    for k in desired_counts:
        hap = reference_with_repeat_count(ref_vntr, chromosome_seq, k,
                                          flank=flank)
        n_reads = max(1, int(len(hap) * coverage / read_length))
        reads = []
        for i in range(n_reads):
            start = rng.randint(0, len(hap) - read_length)
            reads.append((f"c{k}r{i}",
                          mutate(hap[start:start + read_length],
                                 error_rate, rng)))
        res = finder.find_repeat_count([], reads, read_length)
        got = tuple(res.copy_numbers) if res.copy_numbers else None
        rows.append({"desired": k, "called": got,
                     "spanning": res.spanning_reads_count,
                     "flanking": res.flanking_reads_count})
        called[k] = got
        truth[k] = (k, k)   # the edited haplotype is homozygous
    return {"rows": rows, "comparison": compare_genotypes(called, truth)}


def per_locus_accuracy_sweep(run_locus, loci, truth: dict):
    """Per-locus accuracy table: ``run_locus(ref_vntr) -> (a, b) | None``
    applied over ``loci``, diffed against ``truth`` — the per-locus sweep
    the reference's plot.py builds its accuracy figures from."""
    rows = []
    for ref in loci:
        want = truth.get(ref.id)
        try:
            got = run_locus(ref)
            status = "ok" if got is not None and want is not None \
                and tuple(sorted(got)) == tuple(sorted(want)) else "mismatch"
        except Exception as err:       # per-locus isolation, like analyzer
            got, status = None, f"error: {err}"
        rows.append({"vid": ref.id, "expected": want, "called": got,
                     "status": status})
    n_ok = sum(1 for r in rows if r["status"] == "ok")
    return {"rows": rows, "accuracy": n_ok / len(rows) if rows else 0.0}


def consensus_of_units(units: list[str]) -> str:
    """Majority consensus of aligned repeat units."""
    from advntr_tpu_torch.models.msa import center_star_msa
    if not units:
        return ""
    if len(units) == 1:
        return units[0]
    aligned = center_star_msa(units)
    out = []
    for col in range(len(aligned[0])):
        counts = Counter(row[col] for row in aligned)
        best, _ = counts.most_common(1)[0]
        if best != "-":
            out.append(best)
    return "".join(out)


def pairwise_alignment_report(unit: str, consensus: str) -> str:
    """Three-line alignment block (query / match bars / reference), the
    debugging artifact pairwise_aln_generator.py produces per repeat unit."""
    from advntr_tpu_torch.models.msa import needleman_wunsch
    a, b, score = needleman_wunsch(unit, consensus)
    bars = "".join("|" if x == y and x != "-" else " " for x, y in zip(a, b))
    return f"unit:      {a}\n           {bars}\nconsensus: {b}\nscore: {score}"


def locus_alignment_report(sequence: str, visited_states: list[str]) -> str:
    """Per-unit alignment report of a decoded read against the locus
    consensus."""
    from advntr_tpu_torch.engine.analytics import extract_repeating_segments
    units, _ = extract_repeating_segments(sequence, visited_states)
    if not units:
        return "no complete repeat units decoded"
    consensus = consensus_of_units(units)
    blocks = [f"consensus ({len(units)} units): {consensus}", ""]
    for i, unit in enumerate(units):
        blocks.append(f"[unit {i}]")
        blocks.append(pairwise_alignment_report(unit, consensus))
        blocks.append("")
    return "\n".join(blocks)
