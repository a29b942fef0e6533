"""ReferenceVNTR domain object.

Capability-equivalent to the reference's advntr/reference_vntr.py:7-108:
holds the locus pattern, per-copy repeat segments, 500bp flanks and
annotation, and can decompose a raw reference region into repeat segments by
Viterbi-decoding it against the repeat-finder HMM.
"""

from __future__ import annotations


class ReferenceVNTR:
    def __init__(self, vntr_id: int, pattern: str, start_point: int,
                 chromosome: str, gene_name=None, annotation=None,
                 estimated_repeats=None, chromosome_sequence=None,
                 scaled_score: float = 0):
        self.non_overlapping = True
        self.has_homologous = False
        self.id = vntr_id
        self.pattern = pattern
        self.start_point = start_point
        self.chromosome = chromosome
        self.gene_name = gene_name
        self.annotation = annotation
        self.estimated_repeats = estimated_repeats
        self.repeat_segments: list[str] = []
        self.left_flanking_region: str | None = None
        self.right_flanking_region: str | None = None
        self.chromosome_sequence = chromosome_sequence
        self.scaled_score = scaled_score

    def __eq__(self, other):
        if not isinstance(other, ReferenceVNTR):
            return False
        return (self.non_overlapping == other.non_overlapping and
                self.id == other.id and
                self.pattern == other.pattern and
                self.start_point == other.start_point and
                self.chromosome == other.chromosome and
                self.gene_name == other.gene_name and
                self.annotation == other.annotation and
                self.estimated_repeats == other.estimated_repeats and
                sorted(self.repeat_segments) == sorted(other.repeat_segments) and
                self.left_flanking_region == other.left_flanking_region and
                self.right_flanking_region == other.right_flanking_region and
                self.scaled_score == other.scaled_score)

    # ---- construction -----------------------------------------------------

    def init_from_vntrseek_data(self) -> None:
        region = self.get_corresponding_region_in_ref()
        self.repeat_segments = self.find_repeat_segments(region)
        flank = 500
        self.left_flanking_region, self.right_flanking_region = \
            self.get_flanking_regions(flank)
        self.chromosome_sequence = None

    def init_from_loaded(self, repeat_segments, left_flanking_region,
                         right_flanking_region) -> None:
        self.repeat_segments = repeat_segments
        self.left_flanking_region = (None if left_flanking_region == "None"
                                     else left_flanking_region)
        self.right_flanking_region = (None if right_flanking_region == "None"
                                      else right_flanking_region)

    # ---- accessors --------------------------------------------------------

    def is_non_overlapping(self) -> bool:
        return self.non_overlapping

    def has_homologous_vntr(self) -> bool:
        return self.has_homologous

    def get_length(self) -> int:
        return sum(len(e) for e in self.repeat_segments)

    def get_repeat_segments(self) -> list[str]:
        return self.repeat_segments

    # ---- reference decomposition -----------------------------------------

    def find_repeat_segments(self, region_in_ref: str) -> list[str]:
        """Decompose a reference region into per-copy repeat segments by
        Viterbi against the repeat-finder HMM (reference semantics:
        reference_vntr.py:80-87)."""
        from advntr_tpu_torch import dna
        from advntr_tpu_torch.models.graph import build_repeat_finder
        from advntr_tpu_torch.models.compiler import compile_graph, expand_path
        from advntr_tpu_torch.ops.viterbi import viterbi_numpy
        from advntr_tpu_torch.engine.analytics import repeat_segments_from_region

        g = build_repeat_finder(self.pattern, copies=self.estimated_repeats)
        art = compile_graph(g)
        logp, path = viterbi_numpy(art, dna.encode(region_in_ref))
        visited = expand_path(art, path)
        return repeat_segments_from_region(visited, region_in_ref)

    def get_corresponding_region_in_ref(self) -> str:
        ref_sequence = self.chromosome_sequence
        estimated_length = int(len(self.pattern) * self.estimated_repeats)
        region = ref_sequence[self.start_point:
                              self.start_point + estimated_length].upper()
        n_index = region.find("N")
        if n_index != -1:
            region = region[:n_index]
        return region

    def get_flanking_regions(self, flanking_region_size: int = 140):
        ref_sequence = self.chromosome_sequence
        left = ref_sequence[self.start_point - flanking_region_size:
                            self.start_point].upper()
        end = self.start_point + self.get_length()
        right = ref_sequence[end:end + flanking_region_size].upper()
        return left, right
