"""Command-line interface of the PyTorch/CUDA port: ``genotype`` for
Illumina alignments (BAM/SAM/CRAM), with ``-fs`` (frameshift calls of the
loci in ``FRAMESHIFT_VNTRS``) and ``-u``/``--em`` (one model update a
locus, by decoded paths or by Baum-Welch), and, with ``-p``, for PacBio
reads from an alignment or a FASTA/FASTQ file; and the model database's
``viewmodel``, ``addmodel`` (a custom locus, its recruitment threshold
trained on the device), ``delmodel`` and ``buildbank`` (the locus model
bank compiled offline, on the host).

The flags are the reference's (advntr_tpu/cli.py:23-114), with an
explicit ``--device`` on ``genotype`` and ``addmodel``.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import sys

from advntr_tpu_torch.config import Config
from advntr_tpu_torch import __version__
from advntr_tpu_torch.device import DEVICES, resolve_device
from advntr_tpu_torch.utils import profiler

DEFAULT_ILLUMINA_DB = "vntr_data/hg19_selected_VNTRs_Illumina.db"
DEFAULT_PACBIO_DB = "vntr_data/hg19_selected_VNTRs_Pacbio.db"

FRAMESHIFT_VNTRS = [25561, 519759]


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="advntr-tpu-torch",
        description="adVNTR-TPU %s on PyTorch + CUDA: genotyping tool for "
                    "VNTRs" % __version__)
    sub = parser.add_subparsers(title="Commands", dest="command")

    g = sub.add_parser("genotype", help="find RU counts of VNTRs")
    io = g.add_argument_group("Input/output options")
    io.add_argument("-a", "--alignment_file", type=str, metavar="<file>",
                    help="alignment file in SAM/BAM/CRAM format")
    io.add_argument("-r", "--reference_filename", type=str, metavar="<file>",
                    help="FASTA-formatted reference file for CRAM files")
    io.add_argument("-f", "--fasta", type=str, metavar="<file>",
                    help="Fasta file containing raw reads")
    io.add_argument("-p", "--pacbio", action="store_true",
                    help="input contains PacBio reads")
    io.add_argument("--log_pacbio_reads", action="store_true")
    io.add_argument("--accuracy_filter", action="store_true",
                    help="genotype only from confidently spanning reads")
    io.add_argument("-n", "--nanopore", action="store_true",
                    help="input contains Nanopore MinION reads")
    io.add_argument("-o", "--outfile", metavar="<file>", default=None,
                    help="file to write results (default: stdout)")
    io.add_argument("-of", "--outfmt", metavar="<format>", default="text",
                    choices=["text", "bed", "vcf"])
    io.add_argument("--disable_logging", action="store_true", default=False)

    alg = g.add_argument_group("Algorithm options")
    alg.add_argument("-fs", "--frameshift", action="store_true",
                     help="search for frameshifts instead of copy number; "
                          "supported VNTR IDs: %s" % FRAMESHIFT_VNTRS)
    alg.add_argument("-e", "--expansion", action="store_true",
                     help="determine long expansion from PCR-free data")
    alg.add_argument("-c", "--coverage", type=float, metavar="<float>",
                     help="average sequencing coverage in PCR-free sequencing")
    alg.add_argument("--haploid", action="store_true", default=False)
    alg.add_argument("-naive", "--naive", action="store_true", default=False,
                     help="use naive approach for PacBio reads")

    other = g.add_argument_group("Other options")
    other.add_argument("--device", choices=DEVICES, default="cuda",
                       help="where the kernels run: cuda (default; fails "
                            "without a GPU) or cpu (their plain PyTorch "
                            "twins)")
    other.add_argument("--working_directory", type=str, metavar="<path>",
                       default=None)
    other.add_argument("-m", "--models", type=str, metavar="<file>",
                       default=None)
    other.add_argument("-t", "--threads", type=int, metavar="<int>", default=1)
    other.add_argument("-u", "--update", action="store_true", default=False)
    other.add_argument("--em", action="store_true", default=False,
                       help="with --update: Baum-Welch (posterior) model "
                            "re-estimation instead of Viterbi-path "
                            "recounting")
    other.add_argument("-vid", "--vntr_id", type=str, metavar="<text>",
                       default=None, help="comma-separated list of VNTR IDs")

    v = sub.add_parser("viewmodel", help="view existing models in database")
    v.add_argument("-g", "--gene", type=str, default="")
    v.add_argument("-p", "--pattern", type=str, default=None)
    v.add_argument("-m", "--models", type=str, default=None)

    a = sub.add_parser("addmodel", help="add custom VNTR to the database")
    a.add_argument("-r", "--reference", type=str, default=None,
                   help="reference genome FASTA")
    a.add_argument("-c", "--chromosome", type=str, default=None)
    a.add_argument("-p", "--pattern", type=str, default=None)
    a.add_argument("-s", "--start", type=int, default=None)
    a.add_argument("-e", "--end", type=int, default=None)
    a.add_argument("-g", "--gene", type=str, default=None)
    a.add_argument("-a", "--annotation", type=str, default=None)
    a.add_argument("-m", "--models", type=str, default=None)
    a.add_argument("--device", choices=DEVICES, default="cuda",
                   help="where the training reads are scored: cuda "
                        "(default; fails without a GPU) or cpu")

    d = sub.add_parser("delmodel", help="remove a model from database")
    d.add_argument("-vid", "--vntr_id", type=str, default=None)
    d.add_argument("-m", "--models", type=str, default=None)

    b = sub.add_parser(
        "buildbank",
        help="precompile the locus model bank offline (host work only) so "
             "genotyping runs start warm")
    b.add_argument("-m", "--models", type=str, metavar="<file>", default=None)
    b.add_argument("--working_directory", type=str, metavar="<path>",
                   required=True,
                   help="bank is written to <working_directory>/model_bank")
    b.add_argument("-l", "--read_length", type=int, metavar="<int>",
                   default=150)
    b.add_argument("-p", "--pacbio", action="store_true")
    b.add_argument("-n", "--nanopore", action="store_true")
    b.add_argument("-t", "--threads", type=int, metavar="<int>", default=0,
                   help="worker processes (default: all cores)")
    b.add_argument("-vid", "--vntr_id", type=str, metavar="<text>",
                   default=None, help="comma-separated list of VNTR IDs")
    return parser


def _err(msg: str):
    sys.exit("\nERROR: %s" % msg)


def genotype(args) -> None:
    """One genotype call, the root span of its spans; its stage summary is
    logged at INFO as it ends."""
    try:
        with profiler.span(profiler.CALL):
            _genotype(args)
    finally:
        logging.info(profiler.stage_summary())


def _genotype(args) -> None:
    from advntr_tpu_torch.models.db import load_unique_vntrs_data
    from advntr_tpu_torch.engine.analyzer import GenomeAnalyzer

    if args.alignment_file is None and args.fasta is None:
        _err("No input specified. Please specify alignment file or fasta file")
    input_file = args.alignment_file if args.alignment_file else args.fasta
    input_is_alignment = input_file.endswith(("bam", "sam", "cram"))
    if not args.pacbio and not input_is_alignment:
        _err("The input file format is not supported for Illumina. "
             "Please use BAM/SAM files.")
    if args.expansion and args.coverage is None:
        _err("Please specify the average coverage to identify the expansion")
    device = resolve_device(args.device)
    config = Config().with_platform(args.pacbio, args.nanopore)
    if args.threads and args.threads > 0:
        config = dataclasses.replace(config, io_threads=args.threads)
    average_coverage = args.coverage if args.expansion else None
    working_dir = (args.working_directory + "/" if args.working_directory
                   else os.path.dirname(input_file) + "/")
    if not args.disable_logging:
        log_file = working_dir + "log_%s.log" % os.path.basename(input_file)
        logging.basicConfig(
            format="%(asctime)s %(levelname)s:%(message)s",
            filename=log_file, level=logging.DEBUG, filemode="w")
    else:
        logging.disable(level=logging.CRITICAL)

    models_file = args.models
    if models_file is None:
        models_file = DEFAULT_PACBIO_DB if args.pacbio else DEFAULT_ILLUMINA_DB
    reference_vntrs = load_unique_vntrs_data(models_file)
    target_vntrs = [r.id for r in reference_vntrs]
    if args.vntr_id is not None:
        target_vntrs = [int(vid) for vid in args.vntr_id.split(",")]
    logging.info("adVNTR-TPU (torch) %s on %s", __version__, device)
    logging.info("Running for %s VNTRs", len(target_vntrs))

    out = open(args.outfile, "w") if args.outfile else sys.stdout
    analyzer = GenomeAnalyzer(reference_vntrs, target_vntrs, working_dir,
                              args.outfmt, args.haploid,
                              args.reference_filename, input_file,
                              config=config, out=out, device=device)
    try:
        if args.pacbio and input_is_alignment:
            analyzer.find_repeat_counts_from_pacbio_alignment_file(
                input_file, args.log_pacbio_reads, args.accuracy_filter)
        elif args.pacbio:
            analyzer.find_repeat_counts_from_pacbio_reads(
                input_file, args.log_pacbio_reads, args.accuracy_filter,
                args.naive)
        elif args.frameshift:
            if all(v in FRAMESHIFT_VNTRS for v in target_vntrs):
                analyzer.find_frameshift_from_alignment_file(input_file)
            else:
                _err("--frameshift is not available for these VNTRs")
        else:
            analyzer.find_repeat_counts_from_alignment_file(
                input_file, accuracy_filter=args.accuracy_filter,
                average_coverage=average_coverage, update=args.update,
                em=args.em)
    finally:
        analyzer.model_cache.close()
        if args.outfile:
            out.close()


def view_model(args) -> None:
    from advntr_tpu_torch.models.db import load_unique_vntrs_data
    if args.pattern and set(args.pattern.upper()) - set("ACGT"):
        _err("Pattern should only contain A, C, G, T")
    genes = [g.upper() for g in args.gene.split(",") if g]
    print("VNTR ID\t| Chr\t| Gene\t| Start Position | Pattern")
    print("--------------------------------------------------")
    for ref in load_unique_vntrs_data(args.models or DEFAULT_ILLUMINA_DB):
        if genes and (ref.gene_name or "").upper() not in genes:
            continue
        if args.pattern and ref.pattern != args.pattern.upper():
            continue
        gene_name = str(ref.gene_name)
        if len(gene_name) < 7:
            gene_name += "\t"
        print("%s\t| %s\t|%s| %s\t | %s" % (ref.id, ref.chromosome, gene_name,
                                            ref.start_point, ref.pattern))


def add_model(args) -> None:
    from advntr_tpu_torch.engine.training import train_and_add_model
    for field in ("reference", "chromosome", "pattern", "start", "end"):
        if getattr(args, field) is None:
            _err("--%s is required" % field)
    device = resolve_device(args.device)
    vid = train_and_add_model(
        reference_file=args.reference, chromosome=args.chromosome,
        pattern=args.pattern, start=args.start, end=args.end,
        gene=args.gene, annotation=args.annotation,
        db_file=args.models or DEFAULT_ILLUMINA_DB, device=device)
    print("Training completed. VNTR saved with ID: %s to the database" % vid)


def del_model(args) -> None:
    from advntr_tpu_torch.models.db import delete_vntr_from_database
    if not args.vntr_id:
        _err("--vntr_id is required")
    delete_vntr_from_database(int(args.vntr_id),
                              args.models or DEFAULT_ILLUMINA_DB)


def build_bank(args) -> None:
    """Offline model-bank construction (cli.py:231-287): every locus's
    host model build runs once here, in a pool of worker processes, and
    later genotype runs with the same --working_directory start warm.
    The pool spawns its workers: a forked child of a process that holds a
    CUDA context (a smoke run that calls this in-process) is undefined."""
    import concurrent.futures
    import math
    import multiprocessing
    import time

    from advntr_tpu_torch.engine.finder import (bank_payload_path,
                                                build_and_save_payload)
    from advntr_tpu_torch.models.db import load_unique_vntrs_data

    config = Config().with_platform(args.pacbio, args.nanopore)
    models_file = args.models
    if models_file is None:
        models_file = DEFAULT_PACBIO_DB if args.pacbio else DEFAULT_ILLUMINA_DB
    bank_dir = os.path.join(args.working_directory, "model_bank")
    os.makedirs(bank_dir, exist_ok=True)
    reference_vntrs = load_unique_vntrs_data(models_file)
    if args.vntr_id is not None:
        targets = {int(v) for v in args.vntr_id.split(",")}
        reference_vntrs = [r for r in reference_vntrs if r.id in targets]
    read_length = args.read_length
    jobs = []
    for ref in reference_vntrs:
        # the (copies, flank, error) key of the analyzer's get_model
        copies = int(round(read_length / len(ref.pattern) + 0.5))
        path = bank_payload_path(bank_dir, ref.id, copies, read_length,
                                 config.max_error_rate)
        if not os.path.exists(path):
            jobs.append((ref, copies, read_length, config.max_error_rate,
                         path))
    workers = args.threads if args.threads and args.threads > 0 \
        else (os.cpu_count() or 2)
    print("buildbank: %d loci to compile (%d already banked), %d workers"
          % (len(jobs), len(reference_vntrs) - len(jobs), workers))
    t0 = time.perf_counter()
    done = 0
    if jobs:
        with concurrent.futures.ProcessPoolExecutor(
                workers, mp_context=multiprocessing.get_context("spawn")) \
                as pool:
            futs = [pool.submit(build_and_save_payload, *job)
                    for job in jobs]
            tick = max(1, math.ceil(len(futs) / 20))
            for fut in concurrent.futures.as_completed(futs):
                fut.result()
                done += 1
                if done % tick == 0 or done == len(futs):
                    dt = time.perf_counter() - t0
                    print("  %d/%d built (%.1fs, %.0f loci/min)"
                          % (done, len(futs), dt, done / dt * 60),
                          flush=True)
    dt = time.perf_counter() - t0
    print("buildbank: %d loci compiled in %.1fs -> %s"
          % (done, dt, bank_dir))


def main(argv=None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.command == "genotype":
        genotype(args)
    elif args.command == "viewmodel":
        view_model(args)
    elif args.command == "addmodel":
        add_model(args)
    elif args.command == "delmodel":
        del_model(args)
    elif args.command == "buildbank":
        build_bank(args)
    else:
        parser.error("Please specify a valid command")


if __name__ == "__main__":
    main()
