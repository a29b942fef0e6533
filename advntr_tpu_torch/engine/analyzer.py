"""Genome-level orchestration: recruitment, per-locus preparation, device
scoring, and text/BED/VCF output, for Illumina alignments and for long
(PacBio) reads from an alignment or a FASTA/FASTQ file.

Counterpart of advntr_tpu/engine/analyzer.py (genotype paths).  Illumina:

1. one pass of the unmapped reads through the k-mer recruitment filter for
   all target loci;
2. loci run in waves: per locus, an indexed BAM fetch of mapped candidates
   plus the recruited unmapped reads, prepared on the host;
3. same-shape loci score as groups of G on the device, one launch of each
   kernel per group (under ``ADVNTR_TPU_KERNEL=struct``, one sequence of
   the structured decoder's launches a column per group), and each
   finished group appends to a JSONL checkpoint, so an interrupted run
   resumes where it stopped.

Long reads are scored one locus at a time (each locus's model is as wide
as its longest read window): recruitment by flank keywords, then
``VNTRFinder.find_repeat_count_pacbio``.  So are the modes that read
decoded paths: ``-u``/``--em`` (each locus re-estimates its own model)
and ``-fs`` (a frameshift call a locus).

A failure on the device (a kernel build or launch) propagates: there is
no per-locus fallback around dispatch or collection.  A host-side error in
one locus's preparation yields that locus's Error row.
"""

from __future__ import annotations

import json
import logging
import os
import sys
from collections import defaultdict

import numpy as np
import torch

from advntr_tpu_torch import __version__
from advntr_tpu_torch.config import Config, DEFAULT_CONFIG
from advntr_tpu_torch.io import fasta
from advntr_tpu_torch.io.bam import BamReader, get_reference_genome_style
from advntr_tpu_torch.io.sam import open_alignment
from advntr_tpu_torch.utils.profiler import count, span
from advntr_tpu_torch.utils.quality import is_low_quality_read
from advntr_tpu_torch.engine import device_analytics as da
from advntr_tpu_torch.engine.finder import (GenotypeResult, HostStepError,
                                            LocusModelCache, VNTRFinder,
                                            host_step)
from advntr_tpu_torch.engine.recruitment import (build_recruitment_filter,
                                                 filter_reads,
                                                 filter_unmapped)
from advntr_tpu_torch.ops.viterbi_struct import StructDeviceModel
from advntr_tpu_torch.parallel import mesh as pmesh


class GenomeAnalyzer:
    def __init__(self, ref_vntrs, target_vntr_ids, working_dir: str = "./",
                 outfmt: str = "text", is_haploid: bool = False,
                 ref_filename=None, input_file=None,
                 config: Config = DEFAULT_CONFIG, out=None, device="cuda"):
        self.reference_vntrs = ref_vntrs
        self.target_vntr_ids = target_vntr_ids
        self.working_dir = working_dir
        self.outfmt = outfmt
        self.is_haploid = is_haploid
        self.ref_filename = ref_filename
        self.input_file = input_file
        self.config = config
        self.out = out or sys.stdout
        self.device = torch.device(device)
        bank_dir = os.path.join(working_dir, "model_bank") if working_dir \
            else None
        self.model_cache = LocusModelCache(
            device=self.device, workers=max(0, config.io_threads - 1),
            bank_dir=bank_dir)
        self.checkpoint_suffix = ""
        self._panel_mesh_cache = {}
        self.vntr_finder = {}
        for ref_vntr in ref_vntrs:
            if ref_vntr.id in target_vntr_ids:
                self.vntr_finder[ref_vntr.id] = VNTRFinder(
                    ref_vntr, config, is_haploid,
                    model_cache=self.model_cache)

    # ---- output formatting (genome_analyzer.py:28-170) --------------------

    def _print(self, text: str) -> None:
        self.out.write(text + "\n")

    def print_genotype(self, vntr_id, result: GenotypeResult,
                       encountered_error: bool = False) -> None:
        if self.outfmt == "bed":
            self.print_genotype_in_bed(vntr_id, result.copy_numbers,
                                       encountered_error)
        elif self.outfmt == "vcf":
            self.print_genotype_in_vcf(vntr_id, result, encountered_error)
        else:
            self.print_genotype_in_text(vntr_id, result.copy_numbers,
                                        encountered_error)

    def print_genotype_in_text(self, vntr_id, copy_numbers,
                               encountered_error) -> None:
        self._print(str(vntr_id))
        if encountered_error:
            self._print("Error")
        elif copy_numbers is not None:
            if self.is_haploid:
                self._print(str(copy_numbers[0]))
            else:
                self._print("/".join(str(cn) for cn in sorted(copy_numbers)))
        else:
            self._print("None")

    def print_bed_header(self) -> None:
        repeats = "R" if self.is_haploid else "R1\tR2"
        self._print("#CHROM\tStart\tEnd\tVNTR_ID\tGene\tMotif\tRefCopy\t%s"
                    % repeats)

    def print_genotype_in_bed(self, vntr_id, copy_numbers,
                              encountered_error) -> None:
        ref = self.vntr_finder[vntr_id].reference_vntr
        end = ref.start_point + ref.get_length()
        ref_copy = len(ref.get_repeat_segments())
        if encountered_error:
            repeats = "Error"
        elif copy_numbers is None:
            repeats = "None" if self.is_haploid else "None\tNone"
        else:
            repeats = (str(copy_numbers[0]) if self.is_haploid else
                       "\t".join(str(cn) for cn in sorted(copy_numbers)))
        self._print("%s\t%s\t%s\t%s\t%s\t%s\t%s\t%s" % (
            ref.chromosome, ref.start_point, end, vntr_id, ref.gene_name,
            ref.pattern, ref_copy, repeats))

    def print_vcf_header(self) -> None:
        p = self._print
        p("##fileformat=VCFv4.2")
        p("##source=adVNTR-TPU ver. {}".format(__version__))
        p('##INFO=<ID=END,Number=1,Type=Integer,Description="End position of variant">')
        p('##INFO=<ID=VID,Number=1,Type=Integer,Description="VNTR ID">')
        p('##INFO=<ID=RU,Number=1,Type=String,Description="Repeat motif">')
        p('##INFO=<ID=RC,Number=1,Type=Integer,Description="Reference repeat unit count">')
        p('##FILTER=<ID=ERR,Description="Error occurred while genotyping">')
        p('##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">')
        p('##FORMAT=<ID=DP,Number=1,Type=Integer,Description="Read depth">')
        p('##FORMAT=<ID=SR,Number=1,Type=Integer,Description="Spanning read count">')
        p('##FORMAT=<ID=FR,Number=1,Type=Integer,Description="Flanking read count">')
        p('##FORMAT=<ID=ML,Number=1,Type=Float,Description="Maximum likelihood">')
        contigs = {self.vntr_finder[vid].reference_vntr.chromosome[3:]
                   for vid in self.target_vntr_ids}
        for contig in sorted(contigs):
            p("##contig=<ID={}>".format(contig))
        sample = (self.input_file or "sample").strip().split("/")[-1] \
            .split(".")[0]
        p("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t" + sample)

    def print_genotype_in_vcf(self, vntr_id, result: GenotypeResult,
                              encountered_error) -> None:
        vntr = self.vntr_finder[vntr_id].reference_vntr
        end = vntr.start_point + vntr.get_length()
        ref = "".join(vntr.get_repeat_segments())
        consensus = vntr.pattern
        GT = []
        diff_count = 0
        diff_index = -1
        if result.copy_numbers is None:
            GT = [".", "."]
        else:
            for index, copy_number in enumerate(result.copy_numbers):
                if copy_number != vntr.estimated_repeats:
                    diff_index = index
                    diff_count += 1
                    GT.append(diff_count)
                    if len(set(result.copy_numbers)) == 1:
                        GT.append(diff_count)
                        break
                else:
                    GT.append(0)
        if diff_count == 2:
            alt = (consensus * result.copy_numbers[0] + "," +
                   consensus * result.copy_numbers[1])
        elif diff_count == 1:
            alt = consensus * result.copy_numbers[diff_index]
        else:
            alt = "."
        filt = "ERR" if encountered_error else "."
        info = "END={};VID={};RU={};RC={}".format(
            end, vntr_id, vntr.pattern, vntr.estimated_repeats)
        fmt = "{}/{}:{}:{}:{}:{:.4f}".format(
            GT[0], GT[1], result.recruited_reads_count,
            result.spanning_reads_count, result.flanking_reads_count,
            result.maximum_likelihood)
        self._print("{}\t{}\t{}\t{}\t{}\t{}\t{}\t{}\t{}\t{}".format(
            vntr.chromosome, vntr.start_point, ".", ref, alt, ".", filt,
            info, "GT:DP:SR:FR:ML", fmt))

    # ---- recruitment ------------------------------------------------------

    @span("advntr.recruit")
    def recruit_unmapped_reads(self, alignment_file: str,
                               illumina: bool = True):
        """One pass over the unmapped reads for all target loci.
        Returns {vid: [(name, seq), ...]}."""
        filt = build_recruitment_filter(
            self.reference_vntrs, self.target_vntr_ids, short_reads=illumina,
            keyword_size=self.config.keyword_size,
            min_matches=self.config.min_keyword_matches,
            max_reads_per_locus=self.config.max_reads_per_locus,
            device=self.device)

        with open_alignment(alignment_file, self.ref_filename) as reader:
            results, sequences = filter_unmapped(filt, reader,
                                                 batch_size=1024)
        return {vid: [(name, sequences[name])
                      for name, _ in results.get(vid, [])]
                for vid in self.target_vntr_ids}

    @span("advntr.engine.mapped")
    def mapped_candidates(self, bam: BamReader, finder: VNTRFinder,
                          read_length: int):
        """Indexed fetch of mapped candidate reads for one locus
        (reference semantics: vntr_finder.py:727-750)."""
        ref = finder.reference_vntr
        style = get_reference_genome_style(bam.references)
        chromosome = ref.chromosome if style == "HG19" else ref.chromosome[3:]
        vntr_start, vntr_end = finder.vntr_start, finder.vntr_end
        min_len = int(read_length * 0.9)
        if self.config.min_read_length is not None:
            min_len = self.config.min_read_length
        fetched = None
        if isinstance(bam, BamReader):
            try:
                bam._load_index()
            except FileNotFoundError:
                try:
                    from advntr_tpu_torch.io.bam import build_bai
                    logging.info("building BAI index for %s", bam.path)
                    build_bai(bam.path)
                except Exception as error:
                    logging.warning("cannot index %s (%s); scanning "
                                    "sequentially", bam.path, error)
                    fetched = (r for r in bam
                               if r.reference_name == chromosome
                               and not r.is_unmapped)
        if fetched is None:
            fetched = bam.fetch(chromosome, max(0, vntr_start - 500),
                                vntr_end)
        out = []
        n_fetched = 0
        for read in fetched:
            n_fetched += 1
            if read.is_unmapped or read.is_duplicate:
                continue
            if len(read.seq) < min_len:
                continue
            read_end = read.reference_end or \
                read.reference_start + len(read.seq)
            if not (vntr_start - read_length < read.reference_start < vntr_end
                    or vntr_start < read_end < vntr_end):
                continue
            if is_low_quality_read(read.mapq, read.qual,
                                   self.config.mapq_cutoff,
                                   self.config.quality_score_cutoff,
                                   self.config.low_quality_bp_to_discard_read):
                continue
            out.append((read.query_name, read.seq))
        count("mapped.fetched", n_fetched)
        count("mapped.kept", len(out))
        return out

    # ---- result checkpoint/resume (analyzer.py:262-296, 421-453) ----------

    def _emit_header(self):
        if self.outfmt == "bed":
            self.print_bed_header()
        elif self.outfmt == "vcf":
            self.print_vcf_header()

    def _checkpoint_path(self, alignment_file: str):
        if not self.working_dir:
            return None
        base = os.path.basename(alignment_file)
        return os.path.join(
            self.working_dir,
            f"results_checkpoint_{base}{self.checkpoint_suffix}.jsonl")

    @staticmethod
    def _load_checkpoint(path):
        done = {}
        if path and os.path.exists(path):
            with open(path) as fh:
                for line in fh:
                    try:
                        rec = json.loads(line)
                        done[rec["vid"]] = rec
                    except (ValueError, KeyError):
                        continue
        return done

    @staticmethod
    def _checkpoint_record(vid, result: GenotypeResult, err: bool) -> dict:
        return {"vid": vid, "error": err,
                "copy_numbers": list(result.copy_numbers)
                if result.copy_numbers is not None else None,
                "recruited": result.recruited_reads_count,
                "spanning": result.spanning_reads_count,
                "flanking": result.flanking_reads_count,
                "ml": result.maximum_likelihood}

    def _append_checkpoint(self, ckpt_path, vids, results) -> None:
        """Append finished loci as one O_APPEND write, so concurrent
        writers sharing a working directory never tear a record."""
        if not ckpt_path:
            return
        lines = [json.dumps(self._checkpoint_record(vid, *results[vid]))
                 + "\n" for vid in vids if vid in results]
        if not lines:
            return
        data = "".join(lines).encode()
        fd = os.open(ckpt_path, os.O_WRONLY | os.O_APPEND | os.O_CREAT,
                     0o644)
        try:
            written = os.write(fd, data)
            while written < len(data):
                logging.warning("short checkpoint write (%d/%d bytes); "
                                "continuing", written, len(data))
                written += os.write(fd, data[written:])
        finally:
            os.close(fd)

    def _attach_coverage_corrector(self, alignment_file: str) -> None:
        """GC coverage-bias model for the expansion workload (host-only,
        advntr_tpu.engine.coverage_bias; analyzer.py:298-333).  Skipped
        without a reference FASTA."""
        if not self.ref_filename:
            return
        try:
            from advntr_tpu_torch.engine.coverage_bias import (
                CoverageBiasDetector, CoverageCorrector)
            from advntr_tpu_torch.io import fasta
            chromosomes = {f.reference_vntr.chromosome
                           for f in self.vntr_finder.values()}
            refs = {name: seq
                    for name, seq in fasta.read_fasta(self.ref_filename)
                    if name in chromosomes
                    or ("chr" + name) in chromosomes}
            refs = {(n if n.startswith("chr") else "chr" + n): s
                    for n, s in refs.items()}
            detector = CoverageBiasDetector(
                alignment_file, reference_sequences=refs)
            gc_map = detector.get_gc_content_coverage_map()
            if not gc_map:
                logging.warning("coverage-bias: no covered windows found; "
                                "skipping GC correction")
                return
            corrector = CoverageCorrector(gc_map)
            for finder in self.vntr_finder.values():
                finder.coverage_corrector = corrector
        except Exception as error:
            logging.warning("coverage-bias model unavailable (%s); using "
                            "uncorrected coverage", error)

    # ---- the Illumina genotype workload ------------------------------------

    def find_repeat_counts_from_alignment_file(self, alignment_file: str,
                                               accuracy_filter: bool = False,
                                               average_coverage=None,
                                               update: bool = False,
                                               em: bool = False) -> dict:
        if average_coverage:
            self._attach_coverage_corrector(alignment_file)
        ckpt_path = self._checkpoint_path(alignment_file)
        done = self._load_checkpoint(ckpt_path)
        pending = [vid for vid in self.target_vntr_ids if vid not in done]

        results = {}
        if pending:
            unmapped_by_vid = self.recruit_unmapped_reads(alignment_file)
            # waves bound the live set of host model tables
            wave_size = int(os.environ.get("ADVNTR_TPU_LOCI_WAVE", "1024"))
            with open_alignment(alignment_file, self.ref_filename) as bam:
                read_length = self._median_read_length(bam)
                for w0 in range(0, len(pending), wave_size):
                    wave = pending[w0:w0 + wave_size]
                    model_keys = []
                    for vid in wave:
                        finder = self.vntr_finder[vid]
                        key = (finder.reference_vntr,
                               finder.get_copies_for_hmm(read_length),
                               read_length, self.config.max_error_rate)
                        self.model_cache.schedule(*key)
                        model_keys.append(key)
                    results.update(self._genotype_loci_grouped(
                        wave, bam, unmapped_by_vid, read_length,
                        accuracy_filter, average_coverage, update, em,
                        ckpt_path=ckpt_path))
                    for key in model_keys:
                        self.model_cache.evict(*key)

        self._emit_header()
        records = {}
        for vid in self.target_vntr_ids:
            if vid in results:
                result, err = results[vid]
            else:
                rec = done[vid]
                result = GenotypeResult(
                    tuple(rec["copy_numbers"])
                    if rec["copy_numbers"] is not None else None,
                    rec["recruited"], rec["spanning"], rec["flanking"],
                    rec["ml"])
                err = rec["error"]
            records[vid] = self._checkpoint_record(vid, result, err)
            self.print_genotype(vid, result, encountered_error=err)
        return records

    def _genotype_loci_grouped(self, vids, bam, unmapped_by_vid, read_length,
                               accuracy_filter, average_coverage,
                               update: bool = False, em: bool = False,
                               group_size: int = 8, ckpt_path=None):
        """Per-locus prep on the host, then same-shape loci scored as
        groups of ``group_size`` on the device (analyzer.py:455-558).
        Under ``update`` each locus re-estimates its own model, and a
        locus whose model is dense (an imported topology the structured
        extractor refuses) has no group to join, so each of these takes
        the sequential ``find_repeat_count`` (analyzer.py:475-493).  An
        error of a locus's host work (``HostStepError``) gives its Error
        row; a device error propagates."""
        error_result = (GenotypeResult(None, 0, 0, 0, 0), True)
        results: dict = {}
        prepped = {}
        groups = defaultdict(list)
        for vid in vids:
            finder = self.vntr_finder[vid]
            try:
                with host_step():
                    mapped = self.mapped_candidates(bam, finder, read_length)
                if not update:
                    lm = finder.get_model(read_length)
                    reads, rows, row_info = finder.prepare_rows(
                        mapped, unmapped_by_vid[vid])
            except HostStepError as error:
                logging.error("Error preparing VNTR %s: %s.", vid, error)
                results[vid] = error_result
                continue
            if update or (rows and lm.dense is not None):
                try:
                    results[vid] = (finder.find_repeat_count(
                        mapped, unmapped_by_vid[vid],
                        read_length=read_length,
                        accuracy_filter=accuracy_filter,
                        average_coverage=average_coverage, update=update,
                        em=em), False)
                except HostStepError as error:
                    logging.error("Error genotyping VNTR %s: %s.", vid,
                                  error)
                    results[vid] = error_result
                continue
            if not rows:
                results[vid] = (finder.genotype_from_selected(
                    [], accuracy_filter, average_coverage), False)
                continue
            prepped[vid] = (finder, lm, reads, rows, row_info)
            groups[lm.shape_key()].append(vid)

        for members in groups.values():
            for c0 in range(0, len(members), group_size):
                chunk = members[c0:c0 + group_size]
                stats = self._dispatch_group(chunk, prepped, vids,
                                             group_size)
                self._collect_group(chunk, prepped, stats, read_length,
                                    results, accuracy_filter,
                                    average_coverage)
                self._append_checkpoint(ckpt_path, chunk, results)
        self._append_checkpoint(
            ckpt_path, [vid for vid in vids if vid not in prepped], results)
        return results

    def _dispatch_group(self, chunk, prepped, wave, group_size: int):
        """Pad the group's reads to one (G, B, L) batch and score it.

        Shapes follow the reference's buckets (analyzer.py:567-577): L pads
        to a multiple of 32, and the batch axis to a power of two that
        floors at 512 rows in panels of more than 16 loci.  The reference
        also repeats a short chunk's last locus up to G, to keep one
        executable per bucket; with no compiled executables here the
        repeats would only be discarded, so a short chunk scores as is.
        Where more than one device of the analyzer's type is visible, the
        group is split over a (loci, reads) mesh of them
        (parallel/mesh.py, reference analyzer.py:592-623).  Models built
        for the ``struct`` kernel score through the structured decoder
        (reference analyzer.py:609-624)."""
        with span("advntr.decode.stack"):
            max_len = max(max(len(r) for r in prepped[vid][3])
                          for vid in chunk)
            L_pad = ((max_len + 31) // 32) * 32
            max_rows = max(len(prepped[vid][3]) for vid in chunk)
            b_floor = 512 if len(wave) > 16 else 8
            B_pad = max(b_floor, 1 << (max_rows - 1).bit_length())
            batches, lens = [], []
            for vid in chunk:
                finder, lm, reads, rows, row_info = prepped[vid]
                b, ln = finder.pad_rows(rows, length_bucket=1, pad_to=L_pad,
                                        b_pad=B_pad)
                batches.append(b)
                lens.append(ln)
            batch, lens = np.stack(batches), np.stack(lens)
        G = len(chunk)
        count("decode.rows", sum(len(prepped[vid][3]) for vid in chunk))
        count("decode.rows_padded", G * B_pad)
        count("decode.bases", int(sum(lens[g, :len(prepped[vid][3])].sum()
                                      for g, vid in enumerate(chunk))))
        count("decode.cells", G * B_pad * L_pad)
        with span("advntr.decode.launch"):
            seqs = torch.as_tensor(batch, device=self.device)
            lengths = torch.as_tensor(lens, device=self.device)
            lms = [prepped[vid][1] for vid in chunk]
            mesh = self._get_panel_mesh(group_size, B_pad)
            if lms[0].kernel == "struct":
                structs = [lm.struct_model() for lm in lms]
                metas = [lm.model.art_meta for lm in lms]
                suffix_lasts = [lm.sm.suffix_last for lm in lms]
                if mesh is not None:
                    return pmesh.sharded_grouped_read_stats(
                        mesh, structs, seqs, lengths, kernel="struct",
                        metas=metas, suffix_lasts=suffix_lasts)
                return da.read_stats_struct_grouped(
                    StructDeviceModel.stack(structs), da.stack_meta(metas),
                    seqs, lengths,
                    torch.tensor(suffix_lasts, device=self.device))
            models = [lm.model for lm in lms]
            if mesh is not None:
                return pmesh.sharded_grouped_read_stats(mesh, models, seqs,
                                                        lengths)
            return da.read_stats_grouped(models, seqs, lengths)

    def _get_panel_mesh(self, group_size: int, batch: int):
        """(loci, reads) device mesh for the grouped dispatch, or None when
        one device of the analyzer's type is visible (cached per shape;
        reference analyzer.py:625-635)."""
        key = (group_size, batch)
        if key not in self._panel_mesh_cache:
            self._panel_mesh_cache[key] = pmesh.panel_mesh(
                group_size, batch, device_type=self.device.type)
        return self._panel_mesh_cache[key]

    def _collect_group(self, chunk, prepped, stats, read_length, results,
                       accuracy_filter, average_coverage):
        with span("advntr.decode.wait"):
            stats = {k: v.cpu().numpy() for k, v in stats.items()}
        with span("advntr.decode.gates"):
            for g, vid in enumerate(chunk):
                finder, lm, reads, rows, row_info = prepped[vid]
                per = {k: v[g] for k, v in stats.items()}
                covered, flanking, n_sel, _ = finder.counts_from_stats(
                    reads, row_info, per, read_length, accuracy_filter)
                results[vid] = (finder.genotype_from_counts(
                    covered, flanking, n_sel, accuracy_filter,
                    average_coverage), False)

    # ---- frameshift (analyzer.py:654-669) ----------------------------------

    def find_frameshift_from_alignment_file(self, alignment_file: str) -> None:
        """Print each target locus's ID and its frameshift call (or None).
        A locus whose host work fails is logged and prints nothing, as in
        the reference; a device error propagates."""
        unmapped_by_vid = self.recruit_unmapped_reads(alignment_file)
        with open_alignment(alignment_file, self.ref_filename) as bam:
            read_length = self._median_read_length(bam)
            for vid in self.target_vntr_ids:
                finder = self.vntr_finder[vid]
                try:
                    with host_step():
                        mapped = self.mapped_candidates(bam, finder,
                                                        read_length)
                    result = finder.find_frameshift(
                        mapped, unmapped_by_vid[vid], read_length)
                except HostStepError as error:
                    logging.error("Error in frameshift for VNTR %s: %s.",
                                  vid, error)
                    continue
                self._print(str(vid))
                self._print(str(result))

    # ---- the long-read genotype workload (analyzer.py:671-716) -------------

    def _genotype_pacbio_locus(self, vid, unmapped_reads, accuracy_filter,
                               naive: bool = False, bam=None) -> None:
        """Genotype one locus from long reads and print its row.  An error
        in its host work (the walk over the alignment, the model build,
        the haplotyper: ``HostStepError``) yields the locus's Error row,
        as in the reference; anchoring and scoring run on the device,
        where a failure propagates."""
        with span("advntr.locus", vid=vid):
            finder = self.vntr_finder[vid]
            try:
                mapped_spanning = None
                if bam is not None:
                    with host_step():
                        mapped_spanning = finder.\
                            get_spanning_reads_of_aligned_pacbio_reads(bam)
                result = finder.find_repeat_count_pacbio(
                    unmapped_reads, accuracy_filter=accuracy_filter,
                    naive=naive, mapped_spanning=mapped_spanning)
            except HostStepError as error:
                logging.error("Error genotyping VNTR %s: %s. Skipping.", vid,
                              error)
                self.print_genotype(vid, GenotypeResult(None, 0, 0, 0, 0),
                                    encountered_error=True)
                return
            self.print_genotype(vid, result)

    def find_repeat_counts_from_pacbio_alignment_file(
            self, alignment_file: str, log_pacbio_reads: bool = False,
            accuracy_filter: bool = False) -> None:
        unmapped_by_vid = self.recruit_unmapped_reads(alignment_file,
                                                      illumina=False)
        self._emit_header()
        with open_alignment(alignment_file, self.ref_filename) as bam:
            for vid in self.target_vntr_ids:
                self._genotype_pacbio_locus(vid, unmapped_by_vid[vid],
                                            accuracy_filter, bam=bam)

    def find_repeat_counts_from_pacbio_reads(self, read_file: str,
                                             log_pacbio_reads: bool = False,
                                             accuracy_filter: bool = False,
                                             naive: bool = False) -> None:
        filt = build_recruitment_filter(
            self.reference_vntrs, self.target_vntr_ids, short_reads=False,
            keyword_size=self.config.keyword_size,
            min_matches=self.config.min_keyword_matches,
            max_reads_per_locus=self.config.max_reads_per_locus,
            device=self.device)
        with span("advntr.recruit"):
            results, sequences = filter_reads(filt,
                                              fasta.read_any(read_file))
        self._emit_header()
        for vid in self.target_vntr_ids:
            reads = [(name, sequences[name])
                     for name, _ in results.get(vid, [])]
            self._genotype_pacbio_locus(vid, reads, accuracy_filter, naive)

    @staticmethod
    def _median_read_length(bam: BamReader, default: int = 150) -> int:
        lengths = sorted(len(r.seq) for r in bam.head(5))
        return lengths[len(lengths) // 2] if lengths else default
