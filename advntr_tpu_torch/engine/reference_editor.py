"""Mutated-reference simulation for validation (offline analysis).

Capability-equivalent to the reference advntr/reference_editor.py: build
FASTA references whose VNTR has an edited copy number or an injected indel,
used to simulate ground-truth datasets.
"""

from __future__ import annotations

from advntr_tpu_torch.io.fasta import write_fasta


def reference_with_indel(ref_vntr, chromosome_seq: str, position: int,
                         insertion: bool = True, inserted_bp: str = "C",
                         flank: int = 1000) -> str:
    """Locus region with one indel inside the tandem array
    (reference semantics: reference_editor.py:28-43)."""
    start = ref_vntr.start_point
    vntr_end = start + ref_vntr.get_length()
    left = chromosome_seq[start - flank:start]
    vntr = chromosome_seq[start:vntr_end]
    right = chromosome_seq[vntr_end:vntr_end + flank]
    if insertion:
        return left + vntr[:position] + inserted_bp + vntr[position:] + right
    return left + vntr[:position] + vntr[position + 1:] + right


def reference_with_repeat_count(ref_vntr, chromosome_seq: str,
                                desired_repeats: int,
                                flank: int | None = 30000,
                                repeat_patterns=None) -> str:
    """Locus region rebuilt with a specific number of repeat units
    (reference semantics: reference_editor.py:66-97)."""
    start = ref_vntr.start_point
    vntr_end = start + ref_vntr.get_length()
    region_start = 0 if flank is None else start - flank
    region_end = len(chromosome_seq) if flank is None else vntr_end + flank
    repeats = (repeat_patterns if repeat_patterns is not None
               else ref_vntr.get_repeat_segments())
    units = [repeats[i % len(repeats)] for i in range(desired_repeats)]
    return (chromosome_seq[region_start:start] + "".join(units) +
            chromosome_seq[vntr_end:region_end])


def write_reference(sequence: str, name: str, output_file: str) -> None:
    write_fasta(output_file, [(name, sequence)])
