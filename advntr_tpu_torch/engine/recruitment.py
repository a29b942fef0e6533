"""Per-locus recruitment keyword generation and filter orchestration.

Counterpart of advntr_tpu/engine/recruitment.py, whose import pulls in
jax through its filter; ``keywords_for_locus`` is the reference's, copied.
Reference semantics: VNTRFinder.get_keywords_for_filtering
(vntr_finder.py:140-154) — 15-char flank margins around the tandem array,
keywords sampled every 5 bases (6 when the motif is exactly 5bp); for long
reads the keywords are the 80bp flank substrings instead.
"""

from __future__ import annotations

import logging
import subprocess

from advntr_tpu_torch import native_bridge
from advntr_tpu_torch.io.bam import BamReader
from advntr_tpu_torch.io.bam_scan import scan_unmapped
from advntr_tpu_torch.ops.kmer_filter import RecruitmentFilter


def keywords_for_locus(ref_vntr, short_reads: bool = True,
                       keyword_size: int = 21) -> set[str]:
    vntr = "".join(ref_vntr.get_repeat_segments())
    if len(vntr) < keyword_size:
        min_copies = int(keyword_size / len(vntr)) + 1
        vntr = vntr * min_copies
    locus = (ref_vntr.left_flanking_region[-15:] + vntr +
             ref_vntr.right_flanking_region[:15])
    step_size = 5 if len(ref_vntr.pattern) != 5 else 6
    queries = [locus[i:i + keyword_size]
               for i in range(0, len(locus) - keyword_size + 1, step_size)]
    if not short_reads:
        # Long reads: the reference emits the two raw 80bp flank probes
        # (vntr_finder.py:151-152) — but its filter still demands >= 5
        # keyword OCCURRENCES per read (filtering/main.cc:17,282), which
        # two single-occurrence exact 80-mers can never satisfy, and any
        # realistic long-read error rate breaks exact 80bp matches anyway:
        # that configuration recruits nothing.  TPU-native redesign: sample
        # the same flank probes into stepped 15-mers so a noisy long read
        # overlapping a flank accumulates several exact short hits through
        # the one batched counting kernel (no host re-verification pass).
        # Probe density and orientation are chosen for the long-read error
        # model (~1% sub + 4% ins + 4% del): a 15-mer survives intact with
        # p ~ 0.91^15 ~ 0.24, so step-5 forward-only probes (~28/locus)
        # leave a ~25-30% per-read dropout at the >=5-hit gate and reverse
        # -orientation reads recruit NOTHING.  Step 2 (~66 probes/flank
        # pair) pushes expected intact hits to ~16, and the reverse
        # -complement probe set recruits the other orientation (the
        # spanning extractor already decodes both orientations).
        k = 15
        from advntr_tpu_torch.dna import revcomp
        probes = [ref_vntr.left_flanking_region[-80:],
                  ref_vntr.right_flanking_region[:80]]
        probes += [revcomp(p) for p in probes]
        queries = [p[i:i + k]
                   for p in probes
                   for i in range(0, max(1, len(p) - k + 1), 2)]
    return set(queries)


def build_recruitment_filter(ref_vntrs, target_ids, short_reads: bool = True,
                             keyword_size: int = 15, min_matches: int = 5,
                             max_reads_per_locus: int = 2000,
                             device="cuda") -> RecruitmentFilter:
    keywords = {}
    by_id = {v.id: v for v in ref_vntrs}
    for vid in target_ids:
        keywords[vid] = keywords_for_locus(by_id[vid], short_reads,
                                           keyword_size)
    k = min(keyword_size, 15)
    if not short_reads:
        # long reads: a spanning read whose end lands mid-flank covers
        # only ~half the probe windows, and indel noise thins exact
        # 15-mer survival to ~0.24 — demanding 5 hits drops real spanning
        # reads whose evidence the decoder can still use.  3 hits of the
        # ~132-probe set is still ~1e-4 random-hit probability per read.
        min_matches = min(min_matches, 3)
    return RecruitmentFilter(keywords, k=k, min_matches=min_matches,
                             max_reads_per_locus=max_reads_per_locus,
                             device=device)


def filter_reads(filt: RecruitmentFilter, read_iter, batch_size: int = 1024):
    """Stream (name, seq) pairs through the filter in batches."""
    names, seqs = [], []
    for name, seq in read_iter:
        names.append(name)
        seqs.append(seq)
        if len(names) >= batch_size:
            filt.process_batch(names, seqs)
            names, seqs = [], []
    if names:
        filt.process_batch(names, seqs)
    return filt.results()


def filter_unmapped(filt: RecruitmentFilter, reader,
                    batch_size: int = 1024):
    """``filter_reads`` over an alignment file's unmapped records.  A BAM's
    are decoded in bulk (``io/bam_scan.py``): the same reads in the same
    batches.  SAM and CRAM records, and a BAM's where the scan's native
    walk cannot be built, are parsed one at a time."""
    if isinstance(reader, BamReader):
        try:
            native_bridge.load_bam_scan()
        except (OSError, subprocess.CalledProcessError) as error:
            logging.warning("no native BAM scan (%s); parsing %s record by "
                            "record", error, reader.path)
        else:
            for reads in scan_unmapped(reader, batch_size):
                filt.process_packed(reads)
            return filt.results()
    return filter_reads(filt, ((rec.query_name, rec.seq)
                               for rec in reader.fetch_unmapped()),
                        batch_size)
