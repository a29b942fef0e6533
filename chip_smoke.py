#!/usr/bin/env python
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failed check exits non-zero):

1. device: requires CUDA and a compute-capability 9.0 card; prints the
   card's name and power limit as nvidia-smi reports them;
2. build: compiles advntr_tpu_torch/csrc/*.cu with nvcc for sm_90a, one
   compiler per source side by side, and prints what ptxas -v says of
   each kernel (registers, shared memory, spills);
3. kernels at the production shape (the CSTB locus, n_states 927, P 512;
   4096 simulated 150 bp reads, seed 9, padded to L=160) against their
   plain PyTorch twins on the card: B2 bit-identical on the same planes,
   with the path asked for and without it, and its window scheme in plain
   PyTorch likewise; the read_stats dicts equal, logp within rtol 1e-4 / atol 1e-2, 256
   sampled paths rescoring in float64 to the optimum; also a B=5 batch and
   a ragged batch with length-1 rows; then a group of 8 same-shape panel
   loci with their own read batches (a few hundred reads each, ragged,
   padded to at least 512 rows): one grouped B1 and one grouped B2 launch,
   bit-identical to the per-locus twins;
4. timing: median of 10 CUDA-event-timed runs after warm-up, kernels and
   twins, as reads/s, at the cell (G 1, B 4096; there also B1's wide entry
   forced onto the narrow model, in turns with the first entry) and, the
   kernels, at the
   group shape (G 8), each beside its bound: the larger of the bytes it
   must move over 3.35 TB/s and its float32 operations over 67 TFLOP/s,
   counted from this run's inputs; B2 also alone (one launch between two
   events on a prebuilt stack, the L2 cache written over before each, the
   median of 50), with the windows its reads took counted from their
   paths, and the floor of its chain of memory trips: the windows of the
   longest walk times one trip, measured by the same kernel on planes
   where no guess holds (one column a trip);
   also the recruitment filter's top-M count (plain torch ops) at the
   chunk shape of a 6,719-locus panel, against the same call on the host;
5. end to end: the port's CLI on a 24-locus, two-bucket panel (150 bp
   reads, coverage 30; more loci than the filter's top_m of 16, so
   recruitment takes the top-M path as real panels do) and on the CSTB
   2/5 fixture, with --device cuda and --device cpu: identical outputs,
   CSTB 2/5, both kernels launched, and in the warm rerun once per locus
   group, not once per locus.  Prints the cold run's stage totals.

6. long reads (the second path): B1's wide entry and the carried state,
   and B2 over column ranges, against the twins at a shape the twins can
   afford (P 1,536, C 288, B 5 ragged, L 320, segments of 64): planes,
   states, paths bit-identical segment by segment and as a whole;
   segments against whole planes with the kernels at the CSTB cell
   (K 64) and on the long-read model cut to L 2,048 (K 512); the
   long-read path at full width (25-base motif, 60 copies, 4,262 states,
   struct P 2,560 under the engine's padding, 64 reads of L 2,432 at 8%
   substitutions, seed 5) through
   read_stats_ckpt with K 512 and K 1,024, bit-identical, timed, with
   peak device memory and launches, B1's wide entry and B2's ranged walk
   timed alone on one segment beside their bounds (B2 as one launch
   between two events with the L2 cold, and through its wrapper), and on
   that segment, from the same entry state, held to the plain twins at
   full width: B1's planes and exit state over all 512 columns, B2's path
   slice and exit state, bit-identical, the twins' times as measured;
   B1's wide entry on a random model of P 20,480 and C 3,414 (6 bp
   motifs past 16,384 positions: the unit arrays in device memory), one
   16-column launch bit-identical to the twin; local_align against its
   plain version on 3,000-base and 12,288-base reads in both directions,
   one pass a launch and a locus's four passes in one launch, exact,
   timed beside its bound and its chain floor;
7. long reads end to end: ``genotype -p -f`` on a four-locus synthetic
   PacBio panel (noisy 3,000-base reads, both orientations, one long-tract
   locus whose windows pass 2,048 columns): every locus at its simulated
   genotype, the long-tract locus through the checkpointed path and the
   wide entry, one local_align launch a locus, ``--device cpu`` (the
   twins, segment by segment) giving the same text on all four loci, the
   long-tract one included.

    python3 chip_smoke.py --long-tail

also runs the long-read path at its tail shape, L = P = 12,288 (471
copies, 24,815 states), B 8, K 512 against K 1,024, with B1's twin over
16 columns of a segment and B2's over its whole range held to the kernels
(int32 origins, state tables read from device memory).  The host compile
of that model takes minutes and several GB, so it is not in the default
run.

    python3 chip_smoke.py --profile

also reruns the warm panel under torch.profiler and prints its wall time,
the device time per kernel, the device's idle share and the stage totals.

    python3 chip_smoke.py --walk-source FILE[,FILE...]

also builds each FILE (a CUDA source with the committed B2 kernel's C entry
point, such as an earlier version of csrc/viterbi_backward.cu), holds it to
the twin and times it alone in turns with the committed kernel.

    python3 chip_smoke.py --forward-source FILE[,FILE...]

does the same for B1: each FILE must export the committed
csrc/viterbi_forward.cu's C entry point (an earlier version needs its
signature brought up to date).  It is held to the committed kernel and
timed in turns with it at the cell (the whole-read launch, and the wide
entry forced onto the cell's model), at one segment of the long-read
batch (the wide entry with and without planes) and on the whole batch;
under --long-tail at the tail's segment too.

    python3 chip_smoke.py --align-source FILE[,FILE...]

builds each FILE (a source of local_align with the one-probe C entry
point it had before its redesign, such as git show 88b8a7f:
advntr_tpu_torch/csrc/local_align.cu), holds it to the plain version and
times it in turns with the committed kernel at both shapes.

    python3 chip_smoke.py --forward-variant FILE[,FILE...]

times sources whose answers differ by design (the kernel with one part
left out, to see what that part costs) at the long-read segment, in
turns, without holding them to anything.

8. frameshift and model update (the third path): ``genotype -fs`` on
   the frameshift fixture (``synthetic.write_frameshift_sample``, VNTR
   25561, read length 100) with and without its 1-base deletion,
   ``-u`` on the CSTB 2/5 fixture and ``-u --em`` on it at coverage 20,
   each with --device cuda and --device cpu: the same text, a D call on
   the deletion and None on the clean sample, 2/5, and the engine's
   decodes asking B2 for the path; the posterior (B 128) and one
   Baum-Welch pass (B 256) at the CSTB cell's width (n 927 sum-closed,
   L 160), plain PyTorch on the card, timed beside their operation bound
   with peak device memory, their logliks equal to forward_batch (and
   the backward one) within rtol 1e-5; ``run_device(return_paths=True)``
   at the CSTB cell against the twins, paths and statistics
   bit-identical; ``-fs`` at read length 150 (a D call) and the whole
   ``-u --em`` locus at read length 150 (2/5), with its wall time and
   launches.

9. model management (the fourth path): the DNN pre-gate at the
   reference's width (4096 -> 100 -> 2, and with the 50-unit second
   layer): the 6-mer embeddings of the CSTB fixture's unmapped reads
   (150 bp) on the card equal to the CPU's bit for bit; a gate trained on
   the card from parameters carried from a CPU ``init_params`` within
   atol 1e-4 of the same training on the CPU, with equal decisions;
   ``genotype`` with that gate in ``dnn_models/`` giving the same text on
   the card and on the CPU (2/5), the rows it removed printed; ``predict``
   at 8,192 rows and one Adam step timed.  ``addmodel --device cuda`` at
   full width (read length 150, the CSTB dodecamer x 13 with 500-base
   flanks on a seeded 2 Mb chromosome with mutated pieces of the array
   planted: at least 5,000 decoys), its wall time split into the decoy
   scan, the host model build and the scoring, with its B1/B2 launches;
   the same training with the plain twins on the card: the scores within
   rtol 1e-4 / atol 1e-2, the fitted integer thresholds and the stored
   scaled_score equal; a 2/5 sample of the new locus genotyped 2/5.
   Trained-HMM JSON models: the CSTB model saved as pomegranate JSON and
   the 150 bp CSTB fixture genotyped with ``Config.trained_hmms_dir``
   giving the text without it, on the card and on the CPU; a topology the
   structured extractor refuses genotyped through the dense fallback on
   the card (2/5), and the dense fallback at B 256 timed with its peak
   memory, its statistics equal to the CPU's on 32 reads.  ``buildbank
   -t 4`` (spawned workers) on phase 5's panel: the reference's file
   names, a warm ``genotype`` with no host model build giving phase 5's
   text, then ``delmodel`` of one locus and ``viewmodel`` listing 23.

10. scale-out and the offline sweep (the fifth path): the group shape
   of phase 3 through ``parallel.mesh.sharded_grouped_read_stats`` over
   explicit splits of this one card (2 x cuda:0, loci 2 x reads 1, and
   16 x cuda:0, loci 8 x reads 2), and over every card where more than
   one is visible: bit-identical to one unsharded launch, one launch of
   each kernel a shard, timed against it (with the copy of a shard's
   tables to a second card, where there is one); phase 5's 24-locus
   panel through ``parallel.distributed.run_sharded_panel`` in one OS
   process and in two on this card (a guarded worker script; the models
   built in each process as the CLI builds them, and in two processes
   also by one spawned model-build worker each): every run merges to the one
   process's records and to phase 5's genotypes, with its wall time and
   each process's start and run seconds; ``mutated_reference_sweep``
   on the CSTB locus at 150 bp, coverage 30, counts 2, 5 and 9 with the
   finder on the card: every row (k, k), the rows equal to the same
   sweep with a CPU finder, its wall time and launches.

11. the structured decoder (``ADVNTR_TPU_KERNEL=struct``, plain PyTorch,
   no kernel of its own): on the card bit-identical to the CPU (the CSTB
   model, 64 reads); the randomized soak widened to the cell's width
   (P 512, six models of 64 reads) and the long-read model's (P 2,560,
   both sides through their checkpointed paths), B1 and B2 held to it
   under ROADMAP's contract, with its models, rows, tie rows and the
   paths rescored in float64 on the host; ``genotype`` under struct on
   the card for the CSTB fixture and phase 5's panel, equal to
   ``--device cpu``'s (the panel's in a process of its own while the
   card works) and to the default kernel's, launching neither kernel;
   its times by CUDA events at the cell, at the group shape (the CSTB
   model x 8, B 512 each) and on the long-read batch through
   ``read_stats_struct_ckpt`` (held to B1/B2's checkpointed path there),
   with its launches a call (torch.profiler) and peak MiB; and, where
   more than one card is visible, B1, B2 and ``local_align`` on cuda:1's
   tensors with cuda:0 current, bit-identical to cuda:0's (C-4).

The Illumina path (phase 5), the long-read path (phase 7), the
frameshift and update path (phase 8), model management (phase 9),
each path of phase 10 and the struct CLI runs of phase 11 (which must
launch no kernel) are each driven with every launch count set to 0 just
before and read just after (the sharded panel's processes start from 0
and report their own).
The last three lines are the nvidia-smi line, one JSON object of the
kernels, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

LOGP_TOL = dict(rtol=1e-4, atol=1e-2)
N_READS, READ_LEN, L_PAD = 4096, 150, 160
PANEL_LOCI = 24
# the grouped kernel check: 8 same-shape loci, padded to 512 rows each as
# the engine pads a panel of more than 16 loci
GROUP, GROUP_ROWS = 8, 512
# 24 loci in two shape buckets, groups of 8: at most 6 launches of a kernel
MAX_GROUP_LAUNCHES = 6
# the kernels of the Illumina path (narrow models, whole reads); the
# long-read path has its own launches, read in its own phase
ILLUMINA_KERNELS = ("forward", "backward")
# recruitment cell: a 6,719-locus panel, ~40 15-mer keywords per locus,
# one chunk of 150 bp reads
RECRUIT_LOCI, RECRUIT_KEYWORDS = 6719, 40


def fail(msg: str) -> None:
    print("chip_smoke: FAILED: " + msg, file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Median milliseconds of ``iters`` CUDA-event-timed calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def launch_ms(fn, flush, iters: int = 50) -> float:
    """Median milliseconds of one launch of ``fn``, each between its own
    pair of events.  Before each, ``flush`` (larger than the L2 cache) is
    written over: the kernel finds the cache as cold as after the forward
    kernel's plane writes, and the host enqueues the launch while the
    write runs, so the events span device time only."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        flush.zero_()
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def phase_device() -> str:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    cap = torch.cuda.get_device_capability(0)
    log(f"device: {torch.cuda.get_device_name(0)} | {smi} | torch "
        f"{torch.__version__} | CUDA {torch.version.cuda} | capability {cap}")
    check(cap == (9, 0), f"compute capability {cap}, the kernels need (9, 0)")
    return smi


def phase_build(kernels) -> None:
    # always from the sources: drop the libraries an earlier run left
    for lib in kernels.BUILD_DIR.glob("lib*.so"):
        lib.unlink()
    kernels.build()
    for line in kernels.BUILD_LOG.splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            log("build: " + line.strip())
    log(f"build: nvcc sm_90a, {kernels.BUILD_SECONDS:.2f} s")


def phase_kernels(dev):
    from advntr_tpu_torch.ops import viterbi_fused as vf
    from advntr_tpu_torch.ops.struct_model import TorchStructModel
    from advntr_tpu_torch.synthetic import (build_cstb_locus, encode_reads,
                                            padded_structured, rescore,
                                            simulate_cstb_reads)

    graph, art, left, right, pattern = build_cstb_locus(READ_LEN)
    sm = padded_structured(graph, art, pos_bucket=128)
    m = TorchStructModel.from_payload(art, sm, dev)
    check((art.n_states, m.P, m.C, m.nb) == (927, 512, 16, 18),
          f"production locus shape {(art.n_states, m.P, m.C, m.nb)}")
    reads = simulate_cstb_reads(left, pattern, right, READ_LEN, N_READS,
                                seed=9)
    batch, lengths = encode_reads(reads, READ_LEN)
    check(batch.shape == (N_READS, L_PAD), f"batch shape {batch.shape}")
    seqs = torch.as_tensor(batch, device=dev)
    lens = torch.as_tensor(lengths, device=dev)

    # B1 against its twin
    got = vf.fused_forward(m, seqs, lens)
    want = vf.fused_forward_reference(m, seqs, lens)
    torch.cuda.synchronize()
    b1_err = float((got[0] - want[0]).abs().max())
    check(torch.allclose(got[0], want[0], **LOGP_TOL), "B1 logp vs twin")
    check(all(torch.equal(g, w) for g, w in zip(got[1:], want[1:])),
          "B1 bstate/origin planes differ from the twin")
    log(f"B1: max |logp - twin| {b1_err}; bstate and both origin planes "
        f"bit-identical to the twin")

    # B2 against its twin, on B1's own planes and on the twin's
    b2_err = 0.0
    for name, (_, bstate, oMI, oXH) in (("B1's", got), ("the twin's", want)):
        path, stats = vf.backward_stats(m, lens, bstate, oMI, oXH)
        path_w, stats_w = vf.backward_stats_reference(m, lens, bstate, oMI,
                                                      oXH)
        torch.cuda.synchronize()
        check(torch.equal(path, path_w),
              f"B2 path differs from the twin on {name} planes")
        check(torch.equal(stats, stats_w),
              f"B2 stats differ from the twin on {name} planes")
        b2_err = max(b2_err, float((stats - stats_w).abs().max()))
        none, stats_only = vf.backward_stats(m, lens, bstate, oMI, oXH,
                                             return_path=False)
        check(none is None and torch.equal(stats_only, stats_w),
              f"B2 without the path differs from the twin on {name} planes")
    path_p, stats_p = vf.backward_stats_windowed_reference(m, lens, bstate,
                                                           oMI, oXH)
    check(torch.equal(path_p, path_w) and torch.equal(stats_p, stats_w),
          "the window scheme in plain PyTorch differs from the twin")
    log("B2: path and stats bit-identical to the twin on B1's planes and "
        "on the twin's, with and without the path; the window scheme in "
        "plain PyTorch likewise")

    # the full read_stats dict
    out = vf.viterbi_stats(m, seqs, lens, return_path=True)
    ref = vf.viterbi_stats_reference(m, seqs, lens, return_path=True)
    check(torch.allclose(out["logp"], ref["logp"], **LOGP_TOL),
          "read_stats logp vs plain")
    for k in vf.STAT_KEYS:
        check(torch.equal(out[k], ref[k]), f"read_stats[{k}] vs plain")
    rs_err = float((out["logp"] - ref["logp"]).abs().max())
    log(f"read_stats: every statistic equal to the plain pipeline; max "
        f"|logp diff| {rs_err}")

    # sampled paths rescore in float64 to the optimum
    rng = np.random.default_rng(9)
    logp = out["logp"].cpu().numpy()
    paths = out["path"].cpu().numpy()
    for b in rng.choice(N_READS, min(256, N_READS), replace=False):
        n = int(lengths[b])
        s = rescore(art, paths[b][:n], batch[b][:n].astype(np.int64))
        check(abs(s - float(logp[b])) <= 1e-2 + 1e-4 * abs(float(logp[b])),
              f"read {b}: path rescores to {s}, optimum {logp[b]}")
    log("paths: 256 sampled paths rescore in float64 to the optimum")

    # a B=5 batch and a ragged batch with length-1 rows
    ragged = [reads[0], reads[1][:1], reads[2][:37], "A", reads[3][:150],
              reads[4][:2], reads[5][:90], "C", reads[6][:120]]
    for name, rows in (("B=5", reads[:5]), ("ragged", ragged)):
        b, ln = encode_reads(rows, 0)
        s_, l_ = (torch.as_tensor(b, device=dev),
                  torch.as_tensor(ln, device=dev))
        o = vf.viterbi_stats(m, s_, l_, return_path=True)
        r = vf.viterbi_stats_reference(m, s_, l_, return_path=True)
        check(torch.allclose(o["logp"], r["logp"], **LOGP_TOL),
              f"{name} logp")
        check(all(torch.equal(o[k], r[k]) for k in vf.STAT_KEYS + ("path",)),
              f"{name} statistics or paths differ from the plain pipeline")
        o = vf.viterbi_stats(m, s_, l_)
        check("path" not in o
              and all(torch.equal(o[k], r[k]) for k in vf.STAT_KEYS),
              f"{name} statistics without the path differ from the plain "
              f"pipeline")
    log("small batches: B=5 and ragged (length-1 rows) equal the plain "
        "pipeline")
    return m, seqs, lens, (b1_err, b2_err, rs_err)


def phase_group(dev):
    """G = 8 same-shape loci of the panel with their own read batches, as
    the engine prepares and pads them: one grouped launch of each kernel
    against the per-locus twins.  Returns (stack, seqs, lengths)."""
    from advntr_tpu_torch.engine.finder import LocusModelCache, VNTRFinder
    from advntr_tpu_torch.io.bam import BamReader
    from advntr_tpu_torch.models.db import load_unique_vntrs_data
    from advntr_tpu_torch.ops import _kernels
    from advntr_tpu_torch.ops import viterbi_fused as vf
    from advntr_tpu_torch.ops.struct_model import TorchStructModel
    from advntr_tpu_torch.synthetic import write_panel
    tmp = tempfile.mkdtemp(prefix="chip_smoke_group_")
    try:
        db, bam, _ = write_panel(tmp, n_loci=PANEL_LOCI, read_length=150,
                                 coverage=30)
        refs = load_unique_vntrs_data(db)
        by_vid = {}
        with BamReader(bam) as fh:
            for rec in fh:
                by_vid.setdefault(int(rec.query_name.split("_")[0]),
                                  []).append((rec.query_name, rec.seq))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    cache = LocusModelCache(device=dev)
    rng = np.random.default_rng(9)
    groups = {}
    for ref in refs:
        finder = VNTRFinder(ref, model_cache=cache)
        lm = finder.get_model(150)
        # every fifth read cut short, so the batch is ragged
        reads = [(n, s[:int(rng.integers(20, 150))] if i % 5 == 0 else s)
                 for i, (n, s) in enumerate(by_vid[ref.id])]
        _, rows, _ = finder.prepare_rows([], reads)
        groups.setdefault(lm.shape_key(), []).append((lm.model, rows))
    members = max(groups.values(), key=len)[:GROUP]
    check(len(members) == GROUP, f"panel has no {GROUP} same-shape loci")
    n_rows = [len(rows) for _, rows in members]
    # the engine's batch bucket: a power of two, at least GROUP_ROWS
    b_pad = max(GROUP_ROWS, 1 << (max(n_rows) - 1).bit_length())
    batches = [VNTRFinder.pad_rows(rows, length_bucket=1, pad_to=L_PAD,
                                   b_pad=b_pad) for _, rows in members]
    seqs = torch.as_tensor(np.stack([b for b, _ in batches]), device=dev)
    lens = torch.as_tensor(np.stack([ln for _, ln in batches]), device=dev)
    stack = TorchStructModel.stack([m for m, _ in members])
    n0 = dict(_kernels.LAUNCHES)
    got = vf.fused_forward_grouped(stack, seqs, lens)
    walk = vf.backward_stats_grouped(stack, lens, *got[1:])
    torch.cuda.synchronize()
    check(_kernels.LAUNCHES["forward"] == n0["forward"] + 1
          and _kernels.LAUNCHES["backward"] == n0["backward"] + 1,
          "the group took more than one launch of each kernel")
    none, stats_only = vf.backward_stats_grouped(stack, lens, *got[1:],
                                                 return_path=False)
    check(none is None and torch.equal(stats_only, walk[1]),
          "grouped B2 without the path gives other statistics")
    for g, (m, _) in enumerate(members):
        want = vf.fused_forward_reference(m, seqs[g], lens[g])
        check(all(torch.equal(x[g], w) for x, w in zip(got, want)),
              f"grouped B1 differs from the per-locus twin at locus {g}")
        want_walk = vf.backward_stats_reference(m, lens[g], *want[1:])
        check(all(torch.equal(x[g], w) for x, w in zip(walk, want_walk)),
              f"grouped B2 differs from the per-locus twin at locus {g}")
    log(f"group: G={GROUP} same-shape panel loci (P={stack.P}, C={stack.C}), "
        f"{min(n_rows)}-{max(n_rows)} rows each padded to {b_pad}: one "
        f"B1 and one B2 launch, best, bstate, both planes, paths and "
        f"statistics (with and without the path) bit-identical to the "
        f"per-locus twins")
    return stack, seqs, lens


def bounds_ms(stack, seqs, lens):
    """(B1 bound, B2 bound, which) in ms for these inputs on one H100:
    the larger of bytes moved once over 3.35 TB/s and float32 (B1) or
    integer (B2) operations over 67 T/s."""
    G, B, L = seqs.shape
    P, nb = stack.P, stack.nb
    rounds = stack.Wd.shape[1]
    width = 2 if 2 * P + 2 * nb + 2 < (1 << 13) else 4
    tables = sum(getattr(stack, n).numel() * getattr(stack, n).element_size()
                 for n in ("pos", "blk", "eM", "eI", "eI0", "Wd", "Wu",
                           "blk_idx", "exp_base", "unit_last"))
    planes = G * L * B * (2 * P + 2 * nb) * width
    b1_bytes = seqs.numel() + 4 * lens.numel() + tables + planes + 8 * G * B
    active = int(lens.clamp(max=L).sum())
    frozen = G * B * L - active
    # per position: 21 adds and compares in the emitting layer, 10 in the
    # chain inputs, the extraction and the hub entries, 2 a doubling round
    b1_ops = P * (active * (31 + 2 * rounds) + frozen * 21)
    b1 = max((b1_bytes / 3.35e12, "bytes"), (b1_ops / 67e12, "operations"))
    # the walk as the main path runs it (no path written) reads one
    # origin code per read and column inside the read, its length and end
    # state and the state tables, and writes 16 statistics per read;
    # about 40 integer operations a column
    b2_bytes = active * width + G * B * (64 + 8) + 8 * stack.region.numel()
    b2 = max((b2_bytes / 3.35e12, "bytes"),
             (40 * active / 67e12, "operations"))
    return b1[0] * 1e3, b1[1], b2[0] * 1e3, b2[1]


def phase_timing(m, seqs, lens, group):
    from advntr_tpu_torch.ops import viterbi_fused as vf
    from advntr_tpu_torch.ops.struct_model import TorchStructModel
    best, bstate, oMI, oXH = vf.fused_forward_reference(m, seqs, lens)
    runs = {
        "B1": (lambda: vf.fused_forward(m, seqs, lens),
               lambda: vf.fused_forward_reference(m, seqs, lens)),
        "B2": (lambda: vf.backward_stats(m, lens, bstate, oMI, oXH,
                                         return_path=False),
               lambda: vf.backward_stats_reference(m, lens, bstate, oMI,
                                                   oXH)),
        "read_stats": (lambda: vf.viterbi_stats(m, seqs, lens),
                       lambda: vf.viterbi_stats_reference(m, seqs, lens)),
    }
    ms = {}
    for name, (kernel, plain) in runs.items():
        # plain, kernel, kernel, plain: both see the same card state
        p1, k1 = time_ms(plain), time_ms(kernel)
        k2, p2 = time_ms(kernel), time_ms(plain)
        ms[name] = (min(k1, k2), min(p1, p2))
        log(f"timing {name}: kernel {ms[name][0]:.3f} ms "
            f"({N_READS / ms[name][0] * 1e3:.0f} reads/s), plain "
            f"{ms[name][1]:.3f} ms ({N_READS / ms[name][1] * 1e3:.0f} "
            f"reads/s) at B={N_READS}, L={L_PAD}, P={m.P}")
    del best, bstate, oMI, oXH
    # B1's second entry forced onto the cell's narrow model, in turns with
    # the first entry: what one entry for every model would cost here
    from advntr_tpu_torch.ops import _kernels
    one = m.as_stack()
    first = lambda: _kernels.forward(one, seqs[None], lens[None])
    wide = lambda: _kernels.forward(one, seqs[None], lens[None], wide=True)
    check(all(torch.equal(a, b) for a, b in zip(first(), wide())),
          "B1's wide entry differs from the first entry at the cell")
    f1, w1 = time_ms(first), time_ms(wide, iters=5, warmup=1)
    w2, f2 = time_ms(wide, iters=5, warmup=1), time_ms(first)
    ms["B1_wide_at_cell"] = (min(f1, f2), min(w1, w2))
    log(f"timing B1 at the cell, entry by entry: first {min(f1, f2):.3f} ms, "
        f"wide {min(w1, w2):.3f} ms (bit-identical results); the wide "
        f"entry at {wide_occupancy(_kernels, m)[2]}")
    cell = bounds_ms(TorchStructModel.stack([m]), seqs[None], lens[None])
    ms["bound"] = {"B1": cell[:2], "B2": cell[2:]}
    log(f"bound at the cell: B1 {cell[0]:.4f} ms ({cell[1]}), reached "
        f"{cell[0] / ms['B1'][0]:.4f}; B2 {cell[2]:.5f} ms ({cell[3]}), "
        f"held against the kernel alone below")
    # the group shape: one launch of each kernel for G loci
    stack, gseqs, glens = group
    planes = vf.fused_forward_grouped(stack, gseqs, glens)
    g1 = time_ms(lambda: vf.fused_forward_grouped(stack, gseqs, glens))
    g2 = time_ms(lambda: vf.backward_stats_grouped(
        stack, glens, *planes[1:], return_path=False))
    gb = bounds_ms(stack, gseqs, glens)
    ms["group"] = {"B1": g1, "B2": g2, "B1_bound": gb[0], "B2_bound": gb[2]}
    log(f"timing group (G={stack.G}, B={gseqs.shape[1]}, L={gseqs.shape[2]}, "
        f"P={stack.P}): B1 {g1:.3f} ms (bound {gb[0]:.4f} ms, {gb[1]}), "
        f"B2 {g2:.3f} ms (bound {gb[2]:.5f} ms, {gb[3]})")
    return ms


def forward_builds(kernels, sources, variants):
    """Build the other CUDA sources with B1's C entry point, all compilers
    at once: {name: CDLL}, the committed library first.  ``variants`` are
    sources whose results differ by design (a part of the kernel left out
    to time what it costs): they are timed, never held to the committed
    kernel."""
    import ctypes
    libs = kernels.build()
    name = "viterbi_forward.cu"
    builds = {"committed": libs[name]}
    jobs = [(os.path.abspath(src),
             kernels.BUILD_DIR / f"libforward_alt{i}.so")
            for i, src in enumerate(sources + variants)]
    kernels.compile_sources(jobs)
    for src, out in jobs:
        lib = ctypes.CDLL(str(out))
        lib.advntr_viterbi_forward.argtypes = \
            libs[name].advntr_viterbi_forward.argtypes
        lib.advntr_viterbi_forward.restype = ctypes.c_int
        builds[os.path.relpath(src)] = lib
    return builds, {os.path.relpath(src) for src in variants}


def with_build(kernels, builds, build, fn):
    """``fn()`` with B1's library swapped for ``build``'s."""
    libs = kernels.build()
    libs["viterbi_forward.cu"] = builds[build]
    try:
        return fn()
    finally:
        libs["viterbi_forward.cu"] = builds["committed"]


def in_turns(builds, runs, iters):
    """{(run, build): [ms, ...]}: every build, then every build again in
    reverse, twice, each run timed as the median of ``iters``."""
    order = (list(builds) + list(builds)[::-1]) * 2
    times = {}
    for build in order:
        for run, fn in runs.items():
            times.setdefault((run, build), []).append(
                time_ms(lambda: fn(build), iters=iters[run], warmup=1))
    return times


def phase_forward_sources(kernels, builds, variants, m, seqs, lens):
    """B1 at the cell from other CUDA sources with the committed kernel's C
    entry point: the whole-read launch (first entry) and the wide entry
    forced onto the cell's model, held equal to the committed kernel's
    results and timed in turns with it, through the same wrapper."""
    stack = m.as_stack()
    checked = {b: lib for b, lib in builds.items() if b not in variants}
    runs = {
        "first": lambda b: with_build(kernels, builds, b, lambda: (
            kernels.forward(stack, seqs[None], lens[None]))),
        "wide": lambda b: with_build(kernels, builds, b, lambda: (
            kernels.forward(stack, seqs[None], lens[None], wide=True))),
    }
    for run, fn in runs.items():
        want = fn("committed")
        for build in list(checked)[1:]:
            got = fn(build)
            torch.cuda.synchronize()
            check(all(torch.equal(g, w) for g, w in zip(got, want)),
                  f"{build} differs from the committed B1 ({run} entry) at "
                  f"the cell")
        del want
    times = in_turns(checked, runs, {"first": 20, "wide": 5})
    for (run, build), ts in times.items():
        log(f"B1 at the cell, {run} entry: {build} "
            + ", ".join(f"{t:.4f}" for t in ts) + f" ms (medians of "
            f"{20 if run == 'first' else 5}, in turns)")


def phase_wide_sources(kernels, builds, variants, seg):
    """B1's wide entry from other CUDA sources at one segment of the
    long-read batch (``seg``, from phase_long_reads): planes and exit state
    held equal to the committed kernel's (not for ``variants``), timed in
    turns with and without planes; the whole batch too, for the sources
    that are held."""
    from advntr_tpu_torch.engine import device_analytics as da
    stack, cols, lens, entry, c0 = (seg[k] for k in (
        "stack", "cols", "lens", "entry", "c0"))
    m, seqs = seg["model"], seg["seqs"]
    K = cols.shape[2]

    def fwd(b, planes):
        return with_build(kernels, builds, b, lambda: (
            kernels.forward_segment(stack, cols, lens[None], False, entry,
                                    c0, planes)))

    want = fwd("committed", True)
    for build in builds:
        if build == "committed" or build in variants:
            continue
        got = fwd(build, True)
        torch.cuda.synchronize()
        check(all(torch.equal(g, w) for g, w in zip(got[:4], want[:4]))
              and all(torch.equal(g, w) for g, w in zip(got[4], want[4])),
              f"{build}: the wide entry differs from the committed one at "
              f"the long-read segment")
    del want
    runs = {"planes": lambda b: fwd(b, True),
            "no planes": lambda b: fwd(b, False)}
    tail = seg["tail"]
    times = in_turns(builds, runs, {"planes": 3 if tail else 10,
                                    "no planes": 3 if tail else 10})
    checked = {b: lib for b, lib in builds.items() if b not in variants}
    batch = {"batch": lambda b: with_build(kernels, builds, b, lambda: (
        da.read_stats_ckpt(m, seqs, lens, segment=K)))}
    times.update(in_turns(checked, batch, {"batch": 1 if tail else 3}))
    B = cols.shape[1]
    for (run, build), ts in times.items():
        what = ("a batch" if run == "batch" else
                f"a {K}-column segment, {run}")
        log(f"B1 wide entry (B={B}, P={stack.P}), {what}: {build} "
            + ", ".join(f"{t:.3f}" for t in ts) + " ms (in turns)"
            + (f"; {B / min(ts) * 1e3:.1f} reads/s at the best"
               if run == "batch" else
               f"; {min(ts) / K * 1e3:.2f} us a column at the best"))


def phase_walk(kernels, m, seqs, lens, group, sources):
    """B2 alone at the cell and at the group shape: its time between two
    events with the L2 cache cold, the windows its reads took, the byte
    bound and the floor of its chain of memory trips.  ``sources`` are
    other CUDA sources with the same C entry point, timed in turns with
    the committed kernel (the path asked for: an earlier version always
    wrote it)."""
    import ctypes
    from advntr_tpu_torch.ops import viterbi_fused as vf
    dev = seqs.device
    # larger than the L2 cache, and long enough on the device (0.3 ms) to
    # cover the wrapper's host time, which 256 MB did not always do
    flush = torch.empty(1 << 30, dtype=torch.uint8, device=dev)
    libs = kernels.build()
    name = "viterbi_backward.cu"
    builds = {"committed": libs[name]}
    jobs = [(os.path.abspath(src), kernels.BUILD_DIR / f"libwalk_alt{i}.so")
            for i, src in enumerate(sources)]
    if jobs:
        kernels.compile_sources(jobs)
    for src, out in jobs:
        lib = ctypes.CDLL(str(out))
        lib.advntr_viterbi_backward.argtypes = \
            libs[name].advntr_viterbi_backward.argtypes
        lib.advntr_viterbi_backward.restype = ctypes.c_int
        builds[os.path.relpath(src)] = lib

    def walk(build, stack, lengths, planes, return_path):
        libs[name] = builds[build]
        try:
            return kernels.backward(stack, lengths, *planes, return_path)
        finally:
            libs[name] = builds["committed"]

    gstack, gseqs, glens = group
    shapes = {"cell": (m.as_stack(), seqs[None], lens[None]),
              "group": (gstack, gseqs, glens)}
    out = {}
    for shape, (stack, q, n) in shapes.items():
        planes = vf.fused_forward_grouped(stack, q, n)[1:]
        G, B, L = q.shape
        path, stats = walk("committed", stack, n, planes, True)
        for build in list(builds)[1:]:
            got = walk(build, stack, n, planes, True)
            torch.cuda.synchronize()
            check(torch.equal(got[0], path) and torch.equal(got[1], stats),
                  f"{build} differs from the committed B2 at the {shape}")
        windows = torch.cat([
            vf.windows_from_path(path[g], n[g], stack.P,
                                 stack.region.shape[1], 32)
            for g in range(G)])
        columns = int(n.clamp(0, L).sum())
        res = {"windows_mean": float(windows.float().mean()),
               "windows_max": int(windows.max()),
               "columns_per_window": columns / max(int(windows.sum()), 1)}
        del path, stats
        # in turns: every build, then every build again in reverse
        order = list(builds) + list(builds)[::-1]
        with_path = {}
        for build in order:
            t = launch_ms(lambda: walk(build, stack, n, planes, True), flush)
            with_path[build] = min(t, with_path.get(build, t))
        res["ms_path"] = with_path.pop("committed")
        res["ms"] = launch_ms(
            lambda: walk("committed", stack, n, planes, False), flush)
        res["bound_ms"] = bounds_ms(stack, q, n)[2]
        # every code lies alone in a 32-byte sector of its plane row
        res["sector_ms"] = columns * 32 / 3.35e12 * 1e3
        # a launch that walks nothing: every read of length 0
        none = torch.zeros_like(n)
        res["empty_ms"] = launch_ms(
            lambda: walk("committed", stack, none, planes, False), flush)
        if shape == "cell":
            # one trip: the same kernel on planes where two insert states
            # are each other's origin, so no guess holds and a window is
            # one column
            odt = planes[1].dtype
            loop = ((torch.arange(2 * stack.P, device=dev) ^ 1) + 1).to(odt)
            worst = (torch.full_like(n, L),
                     torch.full_like(planes[0], stack.P),
                     loop.expand(G, L, B, -1).contiguous(),
                     torch.zeros_like(planes[2]))
            _, s_worst = walk("committed", stack, worst[0], worst[1:], False)
            path_worst = walk("committed", stack, worst[0], worst[1:],
                              True)[0]
            check(int(s_worst[..., vf.S_NMATCH].max()) == 0
                  and int(vf.windows_from_path(
                      path_worst[0], worst[0][0], stack.P,
                      stack.region.shape[1], 32).min()) == L,
                  "the one-column-a-trip planes did not take a window a "
                  "column")
            del path_worst
            res["trip_ms"] = launch_ms(
                lambda: walk("committed", stack, worst[0], worst[1:], False),
                flush) / L
            del worst, loop
        out[shape] = res
        del planes
        log(f"B2 alone at the {shape} (G={G}, B={B}, L={L}, P={stack.P}): "
            f"{res['ms']:.4f} ms without the path, {res['ms_path']:.4f} ms "
            f"with it (one launch between two events, L2 cold, median of "
            f"50); windows a read: mean {res['windows_mean']:.3f}, max "
            f"{res['windows_max']}, {res['columns_per_window']:.2f} columns "
            f"a window; byte bound {res['bound_ms']:.5f} ms "
            f"({res['sector_ms']:.5f} ms if each code costs its 32-byte "
            f"sector); the same "
            f"launch on reads of length 0 {res['empty_ms']:.4f} ms")
        for build, t in with_path.items():
            log(f"B2 alone at the {shape}: {build} with the path "
                f"{t:.4f} ms")
    trip = out["cell"]["trip_ms"]
    for shape, res in out.items():
        res["floor_ms"] = res["windows_max"] * trip
        log(f"B2 chain floor at the {shape}: {res['windows_max']} trips x "
            f"{trip * 1e3:.3f} us a trip (one column a trip at the cell: "
            f"{trip * L_PAD:.4f} ms for {L_PAD} columns) = "
            f"{res['floor_ms']:.4f} ms; reached "
            f"{res['floor_ms'] / res['ms']:.3f} of it, "
            f"{res['bound_ms'] / res['ms']:.4f} of the byte bound")
    return out


def phase_recruitment(dev):
    """The recruitment filter's top-M count (plain torch ops) at one chunk
    of a 6,719-locus panel: equal to the same call on the host, timed, and
    its peak device memory beside the size of the count plane."""
    from advntr_tpu_torch.ops import kmer_filter as kf
    rng = np.random.default_rng(9)
    kw = rng.integers(0, 4 ** 15, (RECRUIT_LOCI, RECRUIT_KEYWORDS))
    locus = np.repeat(np.arange(RECRUIT_LOCI), RECRUIT_KEYWORDS)
    order = np.lexsort((locus, kw.ravel()))
    codes = kw.ravel()[order].astype(np.int32)
    locus = locus[order].astype(np.int32)
    max_dup = int(np.unique(codes, return_counts=True)[1].max())
    B = kf.recruit_chunk(RECRUIT_LOCI)
    # each 150 bp read is ten keywords drawn from three loci, so counts
    # range over 0..10 with many ties inside a read's top 16
    loci3 = rng.integers(0, RECRUIT_LOCI, (B, 3))
    pick = loci3[np.arange(B)[:, None], rng.integers(0, 3, (B, 10))]
    read_kw = kw[pick, rng.integers(0, RECRUIT_KEYWORDS, (B, 10))]
    shifts = 2 * np.arange(14, -1, -1)
    bases = (read_kw[..., None] >> shifts) & 3            # (B, 10, 15)
    seqs = np.zeros((B, 256), dtype=np.int8)
    seqs[:, :150] = bases.reshape(B, 150)
    lengths = np.full(B, 150, dtype=np.int32)

    def args(device):
        return (torch.as_tensor(codes, device=device),
                torch.as_tensor(locus, device=device),
                torch.as_tensor(seqs, device=device),
                torch.as_tensor(lengths, device=device),
                15, RECRUIT_LOCI, max_dup, 16)

    on_dev, on_cpu = args(dev), args(torch.device("cpu"))
    got = [t.cpu() for t in kf.count_topk(*on_dev)]
    want = kf.count_topk(*on_cpu)
    check(all(torch.equal(g, w) for g, w in zip(got, want)),
          "recruitment top-M counts differ between cuda and cpu")
    check(int(got[0][:, 0].min()) >= 4, "recruitment cell found no hits")
    ms = time_ms(lambda: kf.count_topk(*on_dev))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kf.count_topk(*on_dev)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    plane = B * RECRUIT_LOCI * 4
    log(f"recruitment top-M: {B} reads x {RECRUIT_LOCI} loci "
        f"({len(codes)} keywords) equal to the host; {ms:.3f} ms "
        f"({B / ms * 1e3:.0f} reads/s), peak {peak / 2**20:.1f} MiB for a "
        f"{plane / 2**20:.1f} MiB int32 count plane")


# ---- long reads ----------------------------------------------------------

LONG_L, LONG_B, LONG_K = 2432, 64, 512
TAIL_L, TAIL_B = 12288, 8
HBM_BYTES_PER_S, F32_OPS_PER_S = 3.35e12, 67e12


def phase_wide_vs_twins(dev, kernels):
    """B1's wide entry with the carried state and B2 over column ranges
    against the twins, segment by segment and as a whole, on a model past
    the first entry's limits.  Returns the largest |best - twin|."""
    from advntr_tpu_torch import dna
    from advntr_tpu_torch.engine.simulate import mutate
    from advntr_tpu_torch.ops import viterbi_fused as vf
    from advntr_tpu_torch.ops.struct_model import TorchStructModel
    from advntr_tpu_torch.synthetic import locus_model, rand_seq
    import random
    left, right = rand_seq(7, 60), rand_seq(8, 60)
    art, sm = locus_model(["ACGTA"] * 3, left, right, 260, pos_bucket=128,
                          unit_bucket=32)
    m = TorchStructModel.from_payload(art, sm, dev)
    stack = m.as_stack()
    check(m.P == 1536 and m.C > kernels.MAX_UNITS
          and kernels.takes_wide_entry(stack),
          f"wide check model has P={m.P}, C={m.C}")
    rng = random.Random(3)
    hap = left + "ACGTA" * 40 + right
    reads = [mutate(r, 0.05, rng) for r in
             (hap, hap[10:200], hap[5:150], hap[30:])] + ["A"]
    batch, lengths = dna.pad_batch([dna.encode(r) for r in reads],
                                   pad_to=256, multiple=32)
    seqs = torch.as_tensor(batch, device=dev)
    lens = torch.as_tensor(lengths, device=dev)
    L, K = seqs.shape[1], 64
    want = vf.fused_forward_reference(m, seqs, lens)
    got = vf.fused_forward(m, seqs, lens)
    torch.cuda.synchronize()
    err = float((got[0] - want[0]).abs().max())
    check(all(torch.equal(g, w) for g, w in zip(got, want)),
          "B1 wide entry, whole read, differs from the twin")
    path_w, stats_w = vf.backward_stats_reference(m, lens, *want[1:])
    path, stats = vf.backward_stats(m, lens, *got[1:])
    check(torch.equal(path, path_w) and torch.equal(stats, stats_w),
          "B2 on the wide model differs from the twin")
    state = twin = None
    for c0 in range(0, L, K):
        cols = seqs[:, c0:c0 + K]
        b, e, oMI, oXH, state = vf.fused_forward_segment_grouped(
            stack, cols[None], lens[None], False, state, c0)
        twin, tMI, tXH = vf.fused_forward_segment_reference(
            m, cols, lens, False, twin, c0)
        check(torch.equal(oMI[0], tMI) and torch.equal(oXH[0], tXH)
              and torch.equal(state[0][0], twin[0])
              and torch.equal(state[1][0], twin[1])
              and torch.equal(tMI, want[2][c0:c0 + K]),
              f"B1 wide entry differs from the twin in segment {c0}")
    check(torch.equal(b[0], want[0]) and torch.equal(e[0], want[1]),
          "B1 wide entry: the last segment's best or end state differs")
    cur = cur_t = want[1]
    whole = torch.empty_like(path_w)
    for c0 in reversed(range(0, L, K)):
        planes = (want[2][c0:c0 + K], want[3][c0:c0 + K])
        seg, cur = vf.backward_walk_segment_grouped(
            stack, lens[None], want[1][None], planes[0][None],
            planes[1][None], c0, cur[None])
        cur = cur[0]
        seg_t, _, cur_t = vf.backward_walk_segment_reference(
            m, lens, want[1], *planes, c0, cur_t)
        check(torch.equal(seg[0], seg_t) and torch.equal(cur, cur_t),
              f"B2 over columns {c0}.. differs from the twin")
        whole[:, c0:c0 + K] = seg[0]
    check(torch.equal(whole, path_w), "B2's segments do not add up to the "
                                      "whole walk")
    log(f"wide and carried kernels: P={m.P}, C={m.C}, B={len(reads)} ragged, "
        f"L={L}, K={K}: B1's wide entry and B2's ranged walk bit-identical "
        f"to the twins, segment by segment (planes, states, path slices) "
        f"and as a whole; the wide entry at {wide_occupancy(kernels, m)[2]}")
    return err


# a window past 16,384 positions with 6 bp motifs: B1's wide entry keeps
# the per-unit arrays in device memory there
UNITS_OFF_P, UNITS_OFF_C, UNITS_OFF_B, UNITS_OFF_K = 20480, 3414, 2, 16


def phase_wide_units_off(dev, kernels):
    """B1's wide entry on a model of P 20,480 and C 3,414 (random tables
    from a seed, no host compile), whose per-unit arrays do not fit in
    shared memory: one 16-column launch on B 2 against the twin, planes,
    exit state, best and bstate bit-identical; timed.  Returns a dict for
    the kernels line."""
    from advntr_tpu_torch.ops import viterbi_fused as vf
    from advntr_tpu_torch.synthetic import random_wide_model
    P, C, B, K = UNITS_OFF_P, UNITS_OFF_C, UNITS_OFF_B, UNITS_OFF_K
    m = random_wide_model(P, C, seed=11, device=dev)
    stack = m.as_stack()
    lay, _, occupancy = wide_occupancy(kernels, m)
    check(lay.unit_words > 0,
          f"P={P}, C={C} kept its unit arrays in shared memory")
    rng = np.random.default_rng(11)
    seqs = torch.as_tensor(rng.integers(0, 4, (1, B, K)), dtype=torch.int8,
                           device=dev)
    lens = torch.tensor([[K, K // 2 + 1]], dtype=torch.int32, device=dev)
    run = lambda: kernels.forward_segment(stack, seqs, lens)
    best, bstate, oMI, oXH, state = run()
    t0 = time.perf_counter()
    twin, tMI, tXH = vf.fused_forward_segment_reference(m, seqs[0], lens[0])
    tbest, tbstate = vf.forward_state_best(m, twin)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    check(torch.equal(oMI[0], tMI) and torch.equal(oXH[0], tXH),
          f"B1's wide entry at P={P}, C={C}: planes differ from the twin")
    check(torch.equal(state[0][0], twin[0])
          and torch.equal(state[1][0], twin[1]),
          f"B1's wide entry at P={P}, C={C}: exit state differs")
    check(torch.equal(best[0], tbest) and torch.equal(bstate[0], tbstate),
          f"B1's wide entry at P={P}, C={C}: best or bstate differs")
    ms = time_ms(run, iters=5, warmup=1)
    log(f"wide entry, unit arrays in device memory: P={P}, C={C}, B={B}, "
        f"{K} columns from a random model: planes, exit state, best and "
        f"bstate bit-identical to the twin ({plain_ms:.0f} ms); "
        f"{ms:.3f} ms a launch ({ms / K * 1e3:.2f} us a column); "
        f"{lay.unit_words} 64-bit words of device memory a CTA; at "
        f"{occupancy}")
    return {"P": P, "C": C, "B": B, "columns": K, "ms": ms,
            "plain_ms": plain_ms, "max_abs_err": float(
                (best[0] - tbest).abs().max()),
            "unit_words": lay.unit_words, "smem_bytes": lay.smem,
            "cluster": lay.cluster, "ppt": lay.ppt}


def _segments_equal_whole(da, m, seqs, lens, K, what):
    whole = da.read_stats(m, seqs, lens, return_path=True)
    out = da.read_stats_ckpt(m, seqs, lens, return_path=True, segment=K)
    torch.cuda.synchronize()
    check(set(out) == set(whole)
          and all(torch.equal(out[k], v) for k, v in whole.items()),
          f"{what}: segments of {K} differ from whole planes")
    log(f"segments against whole planes, {what} (B={seqs.shape[0]}, "
        f"L={seqs.shape[1]}, P={m.P}, K={K}): logp, statistics and paths "
        f"bit-identical")


def long_read_bounds(m, B, K, width):
    """Bounds in ms of one K-column segment launch on B reads: B1's wide
    entry with planes (the planes written, the state read and written,
    the bases; about 31 + 2 rounds operations a position and column) and
    without (the states alone), and B2's ranged walk (one code a read
    and column)."""
    P, nb = m.P, m.nb
    rounds = m.Wd.shape[0]
    state = B * (4 * P + 3 * nb) * 4
    plane = K * B * (2 * P + 2 * nb) * width
    ops = P * K * B * (31 + 2 * rounds)
    with_planes = max((plane + 2 * state + K * B) / HBM_BYTES_PER_S,
                      ops / F32_OPS_PER_S)
    bare = max((2 * state + K * B) / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)
    walk = max((K * B * width + B * 16 + 4 * K * B) / HBM_BYTES_PER_S,
               40 * K * B / F32_OPS_PER_S)
    which = "bytes" if (plane + 2 * state) / HBM_BYTES_PER_S \
        > ops / F32_OPS_PER_S else "operations"
    return with_planes * 1e3, bare * 1e3, walk * 1e3, which


def wide_occupancy(kernels, m):
    """(layout, its clusters the card holds at once, a line to log) of B1's
    wide entry for the model ``m``."""
    from advntr_tpu_torch.ops import viterbi_fused as vf
    lay = kernels.wide_layout(m.P, m.nb, m.C, m.Wd.shape[0], m.Wu.shape[0])
    origin32 = vf.origin_params(m.P, m.nb)[0] == torch.int32
    n = kernels.wide_max_clusters(lay, m.C, origin32)
    return lay, n, (f"P={m.P}, C={m.C}: clusters of {lay.cluster} CTAs of "
                    f"{lay.threads} threads, {lay.smem} bytes of shared "
                    f"memory a CTA; the card holds {n} such clusters at once "
                    f"(cudaOccupancyMaxActiveClusters), {n * lay.cluster} "
                    f"CTAs")


def ptxas_lines(kernels, name: str) -> dict:
    """{entry function: (registers, spill store bytes, spill load bytes)}
    from what ptxas -v said of the kernels whose mangled name holds
    ``name`` when this process built."""
    import re
    out, cur = {}, None
    for line in kernels.BUILD_LOG.splitlines():
        if "Compiling entry function" in line:
            cur = line.split("'")[1] if name in line else None
            if cur:
                out[cur] = [None, 0, 0]
        elif cur and "spill stores" in line:
            nums = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
            out[cur][1:] = [int(x) for x in nums]
        elif cur and "Used" in line:
            out[cur][0] = int(re.search(r"Used (\d+) registers",
                                        line).group(1))
    return {k: tuple(v) for k, v in out.items()}


def phase_long_reads(dev, kernels, cell, L, B, tail=False):
    """The long-read path at full width: the long-read locus and its
    reads through read_stats_ckpt, K 512 against K 1,024, timed."""
    from advntr_tpu_torch.engine import device_analytics as da
    from advntr_tpu_torch.engine.finder import LocusModelCache
    from advntr_tpu_torch.models.struct_compiler import build_structured
    from advntr_tpu_torch.ops import viterbi_fused as vf
    from advntr_tpu_torch.synthetic import (build_long_read_locus,
                                            encode_reads,
                                            simulate_long_reads)
    t0 = time.perf_counter()
    graph, art, rng, hap = build_long_read_locus(L)
    lm = LocusModelCache(device=dev)._build_from_payload(
        art, build_structured(graph, art))
    m = lm.model
    host_s = time.perf_counter() - t0
    reads = simulate_long_reads(rng, hap, B, L)
    batch, lengths = encode_reads(reads, L)
    seqs = torch.as_tensor(batch, device=dev)
    lens = torch.as_tensor(lengths, device=dev)
    width = 4 if vf.origin_params(m.P, m.nb)[0] == torch.int32 else 2
    log(f"long-read model: n_states {art.n_states}, struct P {m.P}, C {m.C}, "
        f"{m.Wd.shape[0]} delete rounds, int{8 * width} origins; host build "
        f"{host_s:.1f} s; {B} reads of L={L}")
    if not tail:
        check(m.P == 2560, f"long-read model has struct P {m.P}, not 2560")
        # the same model cut to whole-plane length, and the cell
        _segments_equal_whole(da, m, seqs[:8, :2048],
                              lens[:8].clamp(max=2048), 512,
                              "long-read model cut to L 2,048")
        _segments_equal_whole(da, *cell, 64, "CSTB cell")
    kernels.reset_launches()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = da.read_stats_ckpt(m, seqs, lens, return_path=True, segment=LONG_K)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    launches = dict(kernels.LAUNCHES)
    other = da.read_stats_ckpt(m, seqs, lens, return_path=True,
                               segment=2 * LONG_K)
    torch.cuda.synchronize()
    check(all(torch.equal(out[k], other[k]) for k in out),
          f"L={L}: K {LONG_K} and K {2 * LONG_K} disagree")
    check(bool(torch.isfinite(out["logp"]).all())
          and out["path"].shape == (B, L),
          f"L={L}: logp not finite or path shape {out['path'].shape}")
    n_seg = -(-L // LONG_K)
    check(launches["forward_wide"] == 2 * n_seg
          and launches["backward"] == n_seg and launches["forward"] == 0,
          f"L={L}: launches {launches} for {n_seg} segments")
    copies = out["repeats"].float()
    iters = 1 if tail else 3
    ms = time_ms(lambda: da.read_stats_ckpt(m, seqs, lens, segment=LONG_K),
                 iters=iters, warmup=0 if tail else 1)
    planes_gb = LONG_K * B * (2 * m.P + 2 * m.nb) * width / 1e9
    states_mb = n_seg * B * (4 * m.P + 3 * m.nb) * 4 / 1e6
    # what the two passes must move: pass 2's planes of all L columns and
    # the states pass 1 keeps
    batch_bound = (L * B * (2 * m.P + 2 * m.nb) * width
                   + states_mb * 1e6) / HBM_BYTES_PER_S * 1e3
    log(f"long-read path L={L}, B={B}, P={m.P}, K={LONG_K}: K {LONG_K} and "
        f"K {2 * LONG_K} bit-identical; {ms:.1f} ms a batch "
        f"({B / ms * 1e3:.1f} reads/s); peak device memory "
        f"{peak / 2**20:.1f} MiB (one segment's planes {planes_gb:.3f} GB, "
        f"{n_seg} kept states {states_mb:.1f} MB); launches a batch "
        f"{launches}; repeats decoded {copies.min():.0f}..{copies.max():.0f}"
        f"; bound of the batch {batch_bound:.4f} ms (bytes: pass 2's planes "
        f"and the kept states at 3.35 TB/s), reached "
        f"{batch_bound / ms:.4f}")
    # the two kernels alone on one segment of the batch
    stack = m.as_stack()
    c0 = LONG_K
    cols = seqs[None, :, c0:c0 + LONG_K].contiguous()
    _, _, _, _, entry = vf.fused_forward_segment_grouped(
        stack, seqs[None, :, :c0], lens[None], planes=False)
    fwd = lambda planes, q=cols: vf.fused_forward_segment_grouped(
        stack, q, lens[None], False, entry, c0, planes)
    it = dict(iters=3 if tail else 10, warmup=1)
    b1_ms, b1_bare_ms = time_ms(lambda: fwd(True), **it), \
        time_ms(lambda: fwd(False), **it)
    _, bstate, oMI, oXH, _ = fwd(True)
    walk = lambda: vf.backward_walk_segment_grouped(
        stack, lens[None], bstate, oMI, oXH, c0, bstate)
    b2_wrapper_ms = time_ms(walk, **it)
    # larger than the L2 cache, and long enough on the device (0.3 ms) to
    # cover the wrapper's host time, which 256 MB did not always do
    flush = torch.empty(1 << 30, dtype=torch.uint8, device=dev)
    b2_ms = launch_ms(walk, flush, iters=10 if tail else 50)
    del flush
    bounds = long_read_bounds(m, B, LONG_K, width)
    lay, max_clusters, occupancy = wide_occupancy(kernels, m)
    # the instantiation this model runs: its origin type, positions a
    # thread, units a lane of warp 0 (0: units over several warps) and
    # whether the unit arrays are in device memory, in the mangled name
    off = lay.unit_words > 0
    upl = -(-m.C // 32) if m.C <= kernels.MAX_UNITS and not off else 0
    inst = (f"I{'i' if width == 4 else 's'}Li{lay.ppt}ELi{upl}ELb{int(off)}"
            f"E")
    ptx = [v for k, v in ptxas_lines(kernels, "viterbi_forward_wide_kernel")
           .items() if inst in k]
    regs, spill_st, spill_ld = ptx[0] if ptx else (None, None, None)
    log(f"B1 wide entry layout at P={m.P}, C={m.C}: a cluster of "
        f"{lay.cluster} CTAs of {lay.threads} threads a read, slices of "
        f"{lay.slice} positions ({lay.ppt} a thread), {lay.smem} bytes of "
        f"shared memory a CTA; ptxas: {regs} registers, {spill_st} bytes "
        f"spill stores, {spill_ld} bytes spill loads; {B} reads take "
        f"{B * lay.cluster} CTAs; at {occupancy}")
    log(f"one segment (K={LONG_K}, B={B}, P={m.P}): B1 wide entry "
        f"{b1_ms:.3f} ms with planes (bound {bounds[0]:.4f} ms, "
        f"{bounds[3]}, reached {bounds[0] / b1_ms:.4f}), {b1_bare_ms:.3f} "
        f"ms without (bound {bounds[1]:.4f} ms); "
        f"{b1_ms / LONG_K * 1e3:.2f} us a column; B2 over the range "
        f"{b2_ms:.4f} ms alone (one launch between two events, L2 cold), "
        f"{b2_wrapper_ms:.4f} ms through its wrapper with the host's "
        f"enqueue (bound {bounds[2]:.5f} ms)")
    # the plain twins at this very shape, from the same entry state: B1's
    # twin over the segment's first n columns (the whole segment, or 16
    # columns of the tail shape) against a kernel launch over the same
    # columns, planes and exit state; B2's twin over the whole range
    # against the kernel's path slice and exit state
    n = 16 if tail else LONG_K
    head = cols[:, :, :n].contiguous()
    entry0 = (entry[0][0], entry[1][0])
    twin_out = {}

    def b1_twin(k):
        twin_out["b1"] = vf.fused_forward_segment_reference(
            m, head[0, :, :k], lens, False, entry0, c0)

    b1_twin(2)
    b1_plain_ms = time_ms(lambda: b1_twin(n), iters=1, warmup=0)
    t_state, tMI, tXH = twin_out.pop("b1")
    _, _, kMI, kXH, k_state = fwd(True, head)
    torch.cuda.synchronize()
    b1_err = float((k_state[0][0] - t_state[0]).abs().max())
    check(torch.equal(kMI[0], tMI) and torch.equal(kXH[0], tXH),
          f"L={L}: B1's wide entry differs from the twin in the planes of "
          f"columns {c0}..{c0 + n - 1}")
    check(torch.equal(k_state[0][0], t_state[0])
          and torch.equal(k_state[1][0], t_state[1]),
          f"L={L}: B1's wide entry leaves column {c0 + n - 1} in another "
          f"state than the twin (max |difference| {b1_err})")
    del kMI, kXH, tMI, tXH

    def b2_twin():
        twin_out["b2"] = vf.backward_walk_segment_reference(
            m, lens, bstate[0], oMI[0], oXH[0], c0, bstate[0])

    b2_plain_ms = time_ms(b2_twin, iters=1, warmup=0)
    seg_t, _, cur_t = twin_out.pop("b2")
    seg, cur = walk()
    torch.cuda.synchronize()
    b2_err = max(int((seg[0] - seg_t).abs().max()),
                 int((cur[0] - cur_t).abs().max()))
    check(torch.equal(seg[0], seg_t) and torch.equal(cur[0], cur_t),
          f"L={L}: B2 over columns {c0}..{c0 + LONG_K - 1} differs from the "
          f"twin in the path slice or the exit state")
    log(f"one segment against the plain twins on the card (B={B}, P={m.P}, "
        f"from the state after column {c0 - 1}): B1's wide entry over {n} "
        f"columns, planes and exit state bit-identical (twin "
        f"{b1_plain_ms:.0f} ms for the {n} columns); B2 over the "
        f"{LONG_K}-column range, path slice and exit state bit-identical "
        f"(twin {b2_plain_ms:.0f} ms)")
    return {"ms_batch": ms, "batch_bound_ms": batch_bound,
            "peak_mib": peak / 2**20, "launches": launches,
            "b1_ms": b1_ms, "b1_bare_ms": b1_bare_ms, "b2_ms": b2_ms,
            "b2_wrapper_ms": b2_wrapper_ms,
            "b1_bound_ms": bounds[0], "b1_bare_bound_ms": bounds[1],
            "b2_bound_ms": bounds[2], "b1_bound_by": bounds[3],
            "b1_err": b1_err, "b2_err": b2_err, "twin_columns": n,
            "b1_plain_ms": b1_plain_ms, "b2_plain_ms": b2_plain_ms,
            "cluster": lay.cluster, "slice": lay.slice,
            "max_active_clusters": max_clusters,
            "threads": lay.threads, "smem_bytes": lay.smem,
            "registers": regs, "spill_bytes": spill_st,
            "segment": {"stack": stack, "cols": cols, "lens": lens,
                        "entry": entry, "c0": c0, "model": m, "seqs": seqs,
                        "tail": tail}}


def align_builds(kernels, sources):
    """Build other sources of local_align, all compilers at once, each
    exporting the one-probe C entry point it had before its redesign
    (reads, lengths, probe, score, end, B, L, m, stream).
    Returns {path: CDLL}."""
    import ctypes
    jobs = [(os.path.abspath(src), kernels.BUILD_DIR / f"libalign_alt{i}.so")
            for i, src in enumerate(sources)]
    if not jobs:
        return {}
    kernels.compile_sources(jobs)
    libs = {}
    for src, (_, out) in zip(sources, jobs):
        lib = ctypes.CDLL(str(out))
        fn = lib.advntr_local_align
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        libs[src] = lib
    return libs


def phase_local_align(dev, kernels, sources):
    """local_align against its plain version on 3,000-base and
    12,288-base reads, forward and reversed, one pass a launch and the four
    passes of a locus (two flanks, both directions) in one launch: exact;
    timed beside the bound and the chain floor (the chunk's rows, its
    warm-up and the lanes' skew, times a step of a lone warp); with
    ``sources`` (the one-probe entry point of the kernel before its
    redesign), those kernels held to the plain version and timed in turns
    with the committed one's pass and four passes.  Each
    time is the device's: one call between two events after a write that
    empties the L2 (``launch_ms``; the wrapper's own host time would hide
    a kernel this short), the wrapper's clear of its work words
    included."""
    from advntr_tpu_torch.ops import align
    builds = align_builds(kernels, sources)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    # long enough to write that the host has enqueued the wrapper's clears
    # and launch before it ends (a 256 MB write was not, at times)
    flush = torch.empty(1 << 30, dtype=torch.uint8, device=dev)
    out = {}
    for L, B in ((3008, 64), (12288, 16)):
        rng = np.random.default_rng(L)
        reads = rng.integers(0, 4, (B, L)).astype(np.int8)
        probe = rng.integers(0, 4, 100).astype(np.int8)
        lengths = rng.integers(2000, L + 1, B).astype(np.int32)
        lengths[:2] = [L, 1]
        for i in range(2, B):       # a noisy copy of the probe in each read
            at = int(rng.integers(0, lengths[i] - 100))
            reads[i, at:at + 100] = probe
            flips = rng.random(100) < 0.08
            reads[i, at:at + 100][flips] = rng.integers(0, 4, flips.sum())
        rev = np.stack([np.concatenate([row[:n][::-1], row[n:]])
                        for row, n in zip(reads, lengths)])
        on = lambda x: torch.as_tensor(x, device=dev)
        err = 0
        plain = {}
        for name, r, p in (("forward", reads, probe),
                           ("reversed", rev, probe[::-1].copy())):
            args = [on(x) for x in (r, lengths, p)]
            got = align.local_align_batch(*args)
            t0 = time.perf_counter()
            want = align.local_align_batch_reference(*args)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            plain[name] = want
            err = max(err, *(int((g - w).abs().max())
                             for g, w in zip(got, want)))
            check(torch.equal(got[0], want[0])
                  and torch.equal(got[1], want[1]),
                  f"local_align differs from its plain version at L={L}, "
                  f"{name}")
            check(int(got[0][2:].min()) > 50, "local_align found no probe")
            for src, lib in builds.items():
                score = torch.zeros(B, dtype=torch.int32, device=dev)
                end = torch.zeros_like(score)
                code = lib.advntr_local_align(
                    args[0].data_ptr(), args[1].data_ptr(),
                    args[2].data_ptr(), score.data_ptr(), end.data_ptr(), B,
                    L, 100, torch.cuda.current_stream().cuda_stream)
                torch.cuda.synchronize()
                check(code == 0 and torch.equal(score, want[0])
                      and torch.equal(end, want[1]),
                      f"{src} differs from the plain version at L={L}")
        ms = launch_ms(lambda: align.local_align_batch(*args), flush)
        wrapper_ms = time_ms(lambda: align.local_align_batch(*args))
        # the four passes of a locus in one launch: the probe and a second
        # one, each forward against the reads and reversed against the
        # reversed reads
        second = rng.integers(0, 4, 100).astype(np.int8)
        table = on(np.stack([probe, second, probe[::-1], second[::-1]]))
        both, lens = on(np.stack([reads, rev])), on(lengths)
        # every input on the card before the clock starts: a copy from
        # the host inside would wait for the write before the launch
        passes = lambda: align.local_align_passes(
            both, lens, table, [100] * 4, [0, 0, 1, 1])
        n0 = kernels.LAUNCHES["local_align"]
        score4, end4 = passes()
        check(kernels.LAUNCHES["local_align"] == n0 + 1,
              "the four passes took more than one launch")
        for i, name in ((0, "forward"), (2, "reversed")):
            check(torch.equal(score4[i], plain[name][0])
                  and torch.equal(end4[i], plain[name][1]),
                  f"local_align's four-pass launch differs at L={L}, {name}")
        for i in (1, 3):
            want = align.local_align_batch_reference(
                both[i // 2], lens, table[i])
            check(torch.equal(score4[i], want[0])
                  and torch.equal(end4[i], want[1]),
                  f"local_align's four-pass launch differs at L={L}, pass "
                  f"{i}")
        passes_ms = launch_ms(passes, flush)
        # a step: one read in one chunk is one warp's chain
        chunks = kernels.align_chunks(1, B, L, 100, sms)
        chosen = kernels.align_chunks
        kernels.align_chunks = lambda *a: 1
        one = [on(x) for x in (reads[:1], lengths[:1], probe)]
        try:
            lone = launch_ms(lambda: align.local_align_batch(*one), flush,
                             iters=10)
        finally:
            kernels.align_chunks = chosen
        nl = 25
        step_ns = lone / (L + nl - 1) * 1e6
        rows = -(-L // chunks)
        floor = (rows + 200 + nl - 1) * step_ns * 1e-6
        turns = {}
        if builds:
            runs = {"committed": lambda: align.local_align_batch(*args),
                    "committed, four passes": passes}
            for src, lib in builds.items():
                score = torch.zeros(B, dtype=torch.int32, device=dev)
                end = torch.zeros_like(score)
                runs[src] = lambda lib=lib, score=score, end=end: \
                    lib.advntr_local_align(
                        args[0].data_ptr(), args[1].data_ptr(),
                        args[2].data_ptr(), score.data_ptr(), end.data_ptr(),
                        B, L, 100, torch.cuda.current_stream().cuda_stream)
            for name in (list(runs) + list(runs)[::-1]) * 2:
                turns.setdefault(name, []).append(
                    launch_ms(runs[name], flush, iters=20))
            log(f"local_align in turns at B={B}, L={L} (reversed pass, "
                f"device time, medians of 20): " + "; ".join(
                    f"{k} {', '.join(f'{t:.4f}' for t in v)} ms"
                    for k, v in turns.items()))
        active = int(lengths.sum())
        bound = max((active + 12 * B + 100) / HBM_BYTES_PER_S,
                    12 * 100 * active / F32_OPS_PER_S) * 1e3
        bound4 = max((2 * active + 24 * 4 * B + 400) / HBM_BYTES_PER_S,
                     4 * 12 * 100 * active / F32_OPS_PER_S) * 1e3
        out[L] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "B": B,
                  "err": err, "wrapper_ms": wrapper_ms,
                  "passes_ms": passes_ms,
                  "passes_bound_ms": bound4, "chunks": chunks, "rows": rows,
                  "step_ns": step_ns, "chain_floor_ms": floor,
                  "in_turns": {k: min(v) for k, v in turns.items()}}
        log(f"local_align: B={B}, L={L}, probe 100: (score, end) equal to "
            f"the plain scan, forward and reversed, one pass a launch and "
            f"four in one; kernel {ms:.4f} ms a pass on the device "
            f"({chunks} chunks of {rows} rows a read, {B * chunks} warps; "
            f"{wrapper_ms:.4f} ms through the wrapper with the host's "
            f"enqueue), four passes {passes_ms:.4f} ms; plain scan on the "
            f"card {plain_ms:.0f} ms; "
            f"bound {bound:.5f} ms (operations; four passes {bound4:.5f}); "
            f"a step of a lone warp {step_ns:.2f} ns, chain floor "
            f"({rows} + 200 + {nl - 1} steps) {floor:.4f} ms")
    del flush
    return out


def phase_pacbio_cli(kernels):
    """``genotype -p -f`` on the synthetic PacBio panel, on the card and
    with the twins on the CPU: the same text, every locus."""
    from advntr_tpu_torch.engine import device_analytics as da
    from advntr_tpu_torch.synthetic import write_pacbio_panel
    tmp = tempfile.mkdtemp(prefix="chip_smoke_pacbio_")
    ckpt_calls = []
    orig = da.read_stats_ckpt

    occupancy = set()

    def counted(model, seqs, lengths, **kw):
        ckpt_calls.append((tuple(seqs.shape), model.P))
        if seqs.is_cuda and (model.P > kernels.MAX_THREADS
                             or model.C > kernels.MAX_UNITS):
            occupancy.add(wide_occupancy(kernels, model)[2])
        return orig(model, seqs, lengths, **kw)

    da.read_stats_ckpt = counted
    try:
        db, fa, truth, long_vids = write_pacbio_panel(tmp, n_loci=4,
                                                      coverage=10)

        def argv(wd, device, vids=None):
            os.makedirs(wd, exist_ok=True)
            out = ["genotype", "-p", "-f", fa, "-m", db,
                   "--working_directory", wd, "--disable_logging", "-o",
                   os.path.join(wd, "out.txt"), "--device", device]
            return out + (["-vid", ",".join(map(str, vids))] if vids else [])

        # the long-read main path: every kernel count starts at 0 here
        kernels.reset_launches()
        reset_stages()
        text, secs = run_cli(argv(os.path.join(tmp, "cuda"), "cuda"))
        launches = dict(kernels.LAUNCHES)
        log(f"PacBio panel (cuda): launches {launches}; checkpointed calls "
            f"(batch shape, struct P) {ckpt_calls}; the wide entry at "
            f"{'; at '.join(sorted(occupancy))}; stages: {stage_totals()}")
        for k in ("forward", "forward_wide", "backward", "local_align"):
            check(launches[k] > 0,
                  f"kernel {k} never launched on the long-read path")
        check(len(ckpt_calls) >= 1
              and all(shape[1] > 2048 and P > 1024
                      for shape, P in ckpt_calls),
              f"the long-tract locus did not take the checkpointed path: "
              f"{ckpt_calls}")
        check(launches["local_align"] == len(truth),
              f"PacBio panel: {launches['local_align']} local_align "
              f"launches for {len(truth)} loci, not one a locus")
        lines = text.split()
        calls = dict(zip(lines[0::2], lines[1::2]))
        wrong = {v: (calls.get(str(v)), ab) for v, ab in truth.items()
                 if calls.get(str(v)) != "%d/%d" % ab}
        check(not wrong, f"PacBio panel: wrong calls {wrong}")
        n_cuda = len(ckpt_calls)
        cpu_text, cpu_secs = run_cli(argv(os.path.join(tmp, "cpu"), "cpu"))
        check(cpu_text == text,
              f"PacBio panel: --device cuda gives {text.split()} and "
              f"--device cpu {cpu_text.split()}")
        check(len(ckpt_calls) == 2 * n_cuda,
              "PacBio panel: --device cpu took the checkpointed path "
              f"{len(ckpt_calls) - n_cuda} times, --device cuda {n_cuda}")
        log(f"PacBio panel: {len(truth)}/{len(truth)} loci equal to the "
            f"simulated genotype ({calls}), long-tract locus {long_vids} "
            f"through the checkpointed path; cuda == cpu text on every "
            f"locus, the long-tract one included (the twins by segments, "
            f"{cpu_secs:.1f} s); {secs:.1f} s on the card, host model "
            f"builds included")
        return launches
    finally:
        da.read_stats_ckpt = orig
        shutil.rmtree(tmp, ignore_errors=True)


def sweep_bound_ms(sweeps: int, B: int, n: int, L: int,
                   matmuls: int = 0) -> float:
    """The least time for ``sweeps`` log-sum-exp sweeps over (B, n, n) a
    column for L-1 columns: five float32 operations a term (add, max,
    subtract, exp, sum), plus ``matmuls`` (B, n) x (n, n)-sized products
    a column at two operations a term, over 67 TFLOP/s.  The bytes (the
    tables and reads in, O(B + n^2) out) are under 0.01 ms."""
    terms = B * n * n * (L - 1)
    return (5 * sweeps + 2 * matmuls) * terms / 67e12 * 1e3


def phase_posterior_full_width(dev):
    """The posterior and one Baum-Welch pass at the CSTB cell's width
    (n 927 in the sum-closed form, reads of 150 bp padded to 160): ms
    (CUDA events, median of 3), peak MiB, logliks cross-checked."""
    from advntr_tpu_torch.ops.baum_welch import baum_welch_stats
    from advntr_tpu_torch.ops.posterior import (clean_neg, indel_model,
                                                posterior_indel_batch)
    from advntr_tpu_torch.ops.viterbi import forward_batch
    from advntr_tpu_torch.synthetic import (build_cstb_locus, encode_reads,
                                            simulate_cstb_reads)
    graph, _, left, right, pattern = build_cstb_locus(READ_LEN)
    host, occ = indel_model(graph)
    tables = [clean_neg(x, dev) for x in host]
    occ = torch.as_tensor(occ, device=dev)
    n = tables[0].shape[0]
    check(n == 927, f"sum-closed CSTB model has {n} states, not 927")
    batch, lengths = encode_reads(
        simulate_cstb_reads(left, pattern, right, READ_LEN, 256, seed=9),
        READ_LEN)
    out = {}
    for name, B in (("posterior", 128), ("baum_welch", 256)):
        seqs = torch.as_tensor(batch[:B], device=dev)
        lens = torch.as_tensor(lengths[:B], device=dev)
        L = seqs.shape[1]
        if name == "posterior":
            fn = lambda: posterior_indel_batch(*tables, occ, seqs, lens)
            bound = sweep_bound_ms(3, B, n, L)
        else:
            fn = lambda: baum_welch_stats(*tables[:4], seqs, lens)
            bound = sweep_bound_ms(2, B, n, L, matmuls=1)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        res = fn()
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2**20
        ms = time_ms(fn, iters=3, warmup=0)
        fwd = forward_batch(*tables[:4], seqs, lens)
        ll = res["loglik"]
        check(bool(torch.isfinite(ll).all()), f"{name}: loglik not finite")
        check(torch.allclose(ll, fwd, rtol=1e-5, atol=0),
              f"{name}: loglik differs from forward_batch by "
              f"{float((ll - fwd).abs().max())}")
        if name == "posterior":
            check(torch.allclose(ll, res["loglik_backward"], rtol=1e-5,
                                 atol=0),
                  "posterior: loglik differs from loglik_backward by "
                  f"{float((ll - res['loglik_backward']).abs().max())}")
            check(all(bool(torch.isfinite(res[k]).all()) and
                      res[k].shape == (B,)
                      for k in ("ins_occupancy", "del_mass")),
                  "posterior: occupancy or delete mass not finite")
        else:
            check(all(bool(torch.isfinite(res[k]).all())
                      for k in ("xi", "emit", "gamma_start", "gamma_end")),
                  "baum_welch: counts not finite")
            check(abs(float(res["gamma_start"].sum()) - B) < 1e-2 * B,
                  "baum_welch: start counts do not sum to the reads")
        rel = cpu_slice_rel_err(name, tables, occ, seqs, lens, res)
        out[name] = {"B": B, "n": n, "L": L, "ms": ms, "peak_mib": peak,
                     "bound_ms": bound, "bound_by": "operations",
                     "loglik_vs_forward_max_abs": float(
                         (ll - fwd).abs().max()),
                     "vs_cpu_max_rel_err": rel}
        log(f"{name} at full width (B {B}, n {n}, L {L}): {ms:.3f} ms "
            f"(median of 3), peak {peak:.1f} MiB; bound {bound:.4f} ms "
            f"(operations), reached {bound / ms:.5f}; loglik equal to "
            f"forward_batch within rtol 1e-5 (max abs "
            f"{out[name]['loglik_vs_forward_max_abs']:.3g}); first "
            f"{CPU_SLICE} reads equal to the CPU within rtol 1e-4 ("
            + ", ".join(f"{k} {v:.3g}" for k, v in rel.items()) + ")")
    return out


# reads of the full-width batch that the CPU computes again
CPU_SLICE = 8


def cpu_slice_rel_err(name, tables, occ, seqs, lens, res) -> dict:
    """The card's posterior or Baum-Welch outputs on the first CPU_SLICE
    reads against the same function on the CPU, each within rtol 1e-4
    with an absolute floor of 1e-4 of the output's largest entry: a TF32
    product (10-bit mantissa) would miss it.  The posterior's outputs are
    per read, so the full-width run's rows are held; Baum-Welch sums over
    reads, so the card runs the slice again.  Returns the largest
    relative error of each output."""
    from advntr_tpu_torch.ops.baum_welch import baum_welch_stats
    from advntr_tpu_torch.ops.posterior import posterior_indel_batch
    k = CPU_SLICE
    host = [t.cpu() for t in tables]
    s, n_ = seqs[:k].cpu(), lens[:k].cpu()
    if name == "posterior":
        card = {key: res[key][:k] for key in
                ("loglik", "ins_occupancy", "del_mass")}
        want = posterior_indel_batch(*host, occ.cpu(), s, n_)
    else:
        card = baum_welch_stats(*tables[:4], seqs[:k], lens[:k])
        want = baum_welch_stats(*host[:4], s, n_)
        card = {key: card[key] for key in
                ("loglik", "xi", "emit", "gamma_start", "gamma_end")}
    rel = {}
    for key, got in card.items():
        got, ref = got.cpu(), want[key]
        floor = 1e-4 * float(ref.abs().max())
        rel[key] = float(((got - ref).abs()
                          / ref.abs().clamp(min=floor)).max())
        check(torch.allclose(got, ref, rtol=1e-4, atol=floor),
              f"{name}: {key} on the card differs from the CPU by up to "
              f"{rel[key]:.3g} relative (first {k} reads)")
    return rel


def phase_engine_paths(dev, kernels):
    """B2's path through the engine: ``run_device(..., return_paths=True)``
    at the CSTB cell against the twins on the same inputs."""
    from advntr_tpu_torch.engine.finder import LocusModelCache, VNTRFinder
    from advntr_tpu_torch.ops import viterbi_fused as vf
    from advntr_tpu_torch.synthetic import (build_cstb_locus, encode_reads,
                                            simulate_cstb_reads)
    graph, art, left, right, pattern = build_cstb_locus(READ_LEN)
    lm = LocusModelCache(device=dev)._build(graph, art)
    batch, lengths = encode_reads(
        simulate_cstb_reads(left, pattern, right, READ_LEN, N_READS, seed=9),
        READ_LEN)

    class Engine:
        device = dev
        run_device = VNTRFinder.run_device

    got = Engine().run_device(lm, batch, lengths, return_paths=True)
    want = vf.viterbi_stats_reference(
        lm.model, torch.as_tensor(batch, device=dev),
        torch.as_tensor(lengths, device=dev), return_path=True)
    for k in vf.STAT_KEYS + ("path",):
        check(np.array_equal(got[k], want[k].cpu().numpy()),
              f"run_device(return_paths=True): {k} differs from the twins")
    err = float(np.abs(got["logp"] - want["logp"].cpu().numpy()).max())
    check(np.allclose(got["logp"], want["logp"].cpu().numpy(), **LOGP_TOL),
          "run_device(return_paths=True): logp vs the twins")
    log(f"engine paths: run_device(return_paths=True) at the CSTB cell "
        f"(B {N_READS}, L {batch.shape[1]}): paths and statistics "
        f"bit-identical to the twins, max |logp diff| {err}")


def phase_update_frameshift(dev, kernels):
    """``genotype -fs``, ``-u`` and ``-u --em`` on the card (the third
    path): the texts equal to ``--device cpu`` on the small fixtures, the
    calls checked, the engine's decodes asking B2 for the path; then the
    full-width posterior and Baum-Welch, B2's engine paths against the
    twins, ``-fs`` at read length 150 and the whole ``-u --em`` locus at
    150."""
    from advntr_tpu_torch.engine import device_analytics as da
    from advntr_tpu_torch.synthetic import (write_cstb_sample,
                                            write_frameshift_sample)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_a10_")
    path_calls = []
    orig = da.read_stats

    def counted(model, seqs, lengths, return_path=False, **kw):
        if return_path and seqs.is_cuda:
            path_calls.append(tuple(seqs.shape))
        return orig(model, seqs, lengths, return_path, **kw)

    def fixture(name, writer, *args, **kw):
        wd = os.path.join(tmp, name)
        os.makedirs(wd)
        return writer(wd, *args, **kw)

    def argv(db, bam, name, device, extra):
        wd = os.path.join(tmp, "run_" + name + "_" + device)
        os.makedirs(wd, exist_ok=True)
        return (["genotype", "-a", bam, "-m", db, "--working_directory", wd,
                 "--disable_logging", "-o", os.path.join(wd, "out.txt"),
                 "--device", device] + extra)

    da.read_stats = counted
    try:
        small = {
            "fs_deletion": (fixture("fsd", write_frameshift_sample, 100,
                                    True), ["-fs"]),
            "fs_clean": (fixture("fsc", write_frameshift_sample, 100,
                                 False), ["-fs"]),
            "u": (fixture("cstb", write_cstb_sample), ["-u"]),
            "u_em": (fixture("cstb20", write_cstb_sample, coverage=20),
                     ["-u", "--em"]),
        }
        # this path: every kernel count starts at 0 here
        kernels.reset_launches()
        gpu = {name: run_cli(argv(*files, name, "cuda", extra))
               for name, (files, extra) in small.items()}
        launches = dict(kernels.LAUNCHES)
        n_path = len(path_calls)
        log(f"-fs/-u/--em (cuda): launches {launches}; decodes that asked "
            f"B2 for the path {n_path} (batch shapes "
            f"{sorted(set(path_calls))})")
        for k in ILLUMINA_KERNELS:
            check(launches[k] > 0,
                  f"kernel {k} never launched on the -fs/-u path")
        check(n_path >= 3, "the -fs/-u runs asked B2 for the path "
                           f"{n_path} times")
        text = {k: v[0].split() for k, v in gpu.items()}
        check(text["fs_deletion"][:1] == ["25561"]
              and text["fs_deletion"][1].startswith("D"),
              f"-fs on the deletion sample: {text['fs_deletion']}")
        check(text["fs_clean"] == ["25561", "None"],
              f"-fs on the clean sample: {text['fs_clean']}")
        for k in ("u", "u_em"):
            check(text[k] == ["301645", "2/5"], f"{k}: {text[k]}")
        cpu_s = {}
        for name, (files, extra) in small.items():
            cpu_text, cpu_s[name] = run_cli(argv(*files, name, "cpu", extra))
            check(cpu_text == gpu[name][0],
                  f"{name}: --device cuda gives {text[name]}, --device cpu "
                  f"{cpu_text.split()}")
        log("-fs/-u/--em: cuda == cpu text on the small fixtures ("
            + "; ".join(f"{k} {' '.join(text[k])}: cuda {gpu[k][1]:.2f} s, "
                        f"cpu {cpu_s[k]:.2f} s" for k in small) + ")")

        out = {"launches": launches, "path_decodes": n_path,
               "small_cuda_s": {k: v[1] for k, v in gpu.items()},
               "small_cpu_s": cpu_s}
        out.update(phase_posterior_full_width(dev))
        phase_engine_paths(dev, kernels)

        fs150 = fixture("fs150", write_frameshift_sample, 150, True)
        fs_text, fs_s = run_cli(argv(*fs150, "fs150", "cuda", ["-fs"]))
        check(fs_text.split()[0] == "25561"
              and fs_text.split()[1].startswith("D"),
              f"-fs at read length 150: {fs_text.split()}")
        cstb150 = fixture("cstb150", write_cstb_sample, 150)
        kernels.reset_launches()
        reset_stages()
        em_text, em_s = run_cli(argv(*cstb150, "em150", "cuda",
                                     ["-u", "--em"]))
        em_launches = dict(kernels.LAUNCHES)
        check(em_text.split() == ["301645", "2/5"],
              f"-u --em at read length 150: {em_text.split()}")
        log(f"-fs at read length 150 (cuda): {' '.join(fs_text.split())} in "
            f"{fs_s:.2f} s; -u --em locus at read length 150 (cuda): "
            f"{' '.join(em_text.split())} in {em_s:.2f} s, launches "
            f"{em_launches}; stages: {stage_totals()}")
        out.update({"fs150_s": fs_s, "em150_s": em_s,
                    "em150_launches": em_launches})
        return out
    finally:
        da.read_stats = orig
        shutil.rmtree(tmp, ignore_errors=True)


# ---- model management (phase 9) ---------------------------------------------

# the gate's timed shape, and its card-against-CPU tolerance
GATE_ROWS, GATE_ATOL = 8192, 1e-4
# the dense fallback's timed batch, and the reads the CPU computes again
DENSE_B, DENSE_CPU_READS = 256, 32


def gate_bound_ms(model, rows: int) -> tuple[float, str]:
    """The least time of ``predict`` on (rows, 4096) embeddings: its
    float32 products (two operations a multiply-add) over 67 TFLOP/s
    against the embeddings, weights and output moved once over
    3.35 TB/s; the larger, and which."""
    params = sum(p.numel() for p in model.parameters())
    macs = sum(p.numel() for n, p in model.named_parameters()
               if n.startswith("w"))
    ops_ms = 2 * rows * macs / 67e12 * 1e3
    bytes_ms = 4 * (rows * 4096 + params + rows * 2) / 3.35e12 * 1e3
    return max(ops_ms, bytes_ms), \
        "operations" if ops_ms >= bytes_ms else "bytes"


def _spy(obj, name, calls):
    """Wrap ``obj.name`` so that each call appends (args, result,
    seconds) to ``calls``; returns the original."""
    orig = getattr(obj, name)

    def wrapped(*args, **kw):
        t0 = time.perf_counter()
        out = orig(*args, **kw)
        calls.append((args, out, time.perf_counter() - t0))
        return out

    setattr(obj, name, wrapped)
    return orig


def genotype_text(db, bam, workdir, device, **fields) -> str:
    """``genotype`` of every locus of ``db`` through the GenomeAnalyzer
    with Config ``fields`` the CLI has no flag for, as the CLI runs it
    (one I/O thread, no worker pool); the text."""
    import dataclasses
    from advntr_tpu_torch.config import Config
    import io
    from advntr_tpu_torch.engine.analyzer import GenomeAnalyzer
    from advntr_tpu_torch.models.db import load_unique_vntrs_data
    os.makedirs(workdir, exist_ok=True)
    refs = load_unique_vntrs_data(db)
    buf = io.StringIO()
    analyzer = GenomeAnalyzer(refs, [r.id for r in refs], workdir + "/",
                              "text", False, None, bam,
                              config=dataclasses.replace(
                                  Config(), io_threads=1, **fields),
                              out=buf, device=device)
    try:
        analyzer.find_repeat_counts_from_alignment_file(bam)
    finally:
        analyzer.model_cache.close()
    return buf.getvalue()


def phase_gate(dev, tmp):
    """The DNN pre-gate on the card at the reference's width."""
    from advntr_tpu_torch import dna
    from advntr_tpu_torch.engine import deep_recruitment as dr
    from advntr_tpu_torch.engine import finder as finder_mod
    from advntr_tpu_torch.io.bam import BamReader
    from advntr_tpu_torch.synthetic import rand_seq, write_cstb_sample
    cpu = torch.device("cpu")
    wd = os.path.join(tmp, "gate")
    os.makedirs(wd)
    db, bam = write_cstb_sample(wd, read_length=READ_LEN)
    with BamReader(bam) as reader:
        reads = [r.seq for r in reader]
        unmapped = [r.seq for r in reader.fetch_unmapped()]
    rows = []
    for seq in unmapped:
        codes = dna.encode(seq)
        rows += [codes, dna.revcomp_codes(codes)]
    batch, lengths = dna.pad_batch(rows, multiple=8)
    emb = dr.embed_batch(batch, lengths, dev)
    check(torch.equal(emb.cpu(), dr.embed_batch(batch, lengths, cpu)),
          "gate: embeddings on the card differ from the CPU's")
    out = {"unmapped_rows": len(rows)}
    # training set: every read of the fixture (VNTR) against 200 seeded
    # random reads
    negatives = [rand_seq(5000 + i, READ_LEN) for i in range(200)]
    tb, tl = dna.pad_batch([dna.encode(s) for s in reads + negatives],
                           multiple=8)
    x = dr.embed_batch(tb, tl, dev)
    labels = np.array([1] * len(reads) + [0] * len(negatives))
    models = {}
    orig_init = dr.init_params
    try:
        for second in (0, 50):
            start = orig_init(second_layer=second,
                              generator=torch.Generator().manual_seed(0))
            carried = start.to_numpy()
            dr.init_params = lambda first_layer=100, second_layer=0, \
                generator=None: dr.RecruitmentMLP.from_numpy(carried)
            card = dr.train(x, labels, epochs=3, second_layer=second,
                            device=dev)
            host = dr.train(x.cpu(), labels, epochs=3, second_layer=second,
                            device="cpu")
            err = max(float(np.abs(v - host.to_numpy()[k]).max())
                      for k, v in card.to_numpy().items())
            check(err <= GATE_ATOL,
                  f"gate ({second} second-layer units): parameters trained "
                  f"on the card differ from the CPU's by {err}")
            p_card = dr.predict(card, torch.cat([x, emb])).cpu()
            p_host = dr.predict(host, torch.cat([x, emb]).cpu())
            margin = float((p_host[:, 0] - p_host[:, 1]).abs().min())
            check(torch.equal(p_card[:, 0] > p_card[:, 1],
                              p_host[:, 0] > p_host[:, 1]),
                  f"gate ({second} second-layer units): decisions on the "
                  f"card differ from the CPU's (smallest margin {margin})")
            models[second] = card
            out[f"train_vs_cpu_max_abs_err_{second}"] = err
            out[f"decision_min_margin_{second}"] = margin
    finally:
        dr.init_params = orig_init
    log(f"gate: embeddings of {len(rows)} unmapped rows bit-identical to "
        f"the CPU; trained on the card from carried parameters, 3 epochs "
        f"of {len(labels)} reads: within {out['train_vs_cpu_max_abs_err_0']:.3g}"
        f" (4096-100-2) and {out['train_vs_cpu_max_abs_err_50']:.3g} "
        f"(4096-100-50-2) of the CPU, decisions equal (smallest margins "
        f"{out['decision_min_margin_0']:.3g}, "
        f"{out['decision_min_margin_50']:.3g})")

    # genotype with the gate in dnn_models/ under the working directory
    os.makedirs(os.path.join(wd, "dnn_models"))
    dr.save_model(models[0], os.path.join(wd, "dnn_models", "301645.npz"))
    gated = []
    orig_gate = _spy(finder_mod.VNTRFinder, "_dnn_gate", gated)
    here = os.getcwd()
    os.chdir(wd)
    try:
        texts = {}
        for device in ("cuda", "cpu"):
            run = os.path.join(wd, "run_" + device)
            os.makedirs(run)
            texts[device], out[f"genotype_{device}_s"] = run_cli(
                ["genotype", "-a", bam, "-m", db, "--working_directory",
                 run, "--disable_logging", "-o",
                 os.path.join(run, "out.txt"), "--device", device])
    finally:
        os.chdir(here)
        finder_mod.VNTRFinder._dnn_gate = orig_gate
    check(texts["cuda"] == texts["cpu"],
          f"gated genotype: cuda {texts['cuda'].split()}, cpu "
          f"{texts['cpu'].split()}")
    check(texts["cuda"].split() == ["301645", "2/5"],
          f"gated genotype: {texts['cuda'].split()}")
    removed = [sum(not v for v in res.values()) for _, res, _ in gated]
    check(len(gated) == 2 and removed[0] == removed[1],
          f"gate: rows removed on the card and the CPU {removed}")
    out["rows_gated_out"] = removed[0]
    out["unmapped_orientations"] = len(gated[0][1])
    log(f"gated genotype: 301645 2/5 on the card and the CPU; the gate "
        f"removed {removed[0]} of {len(gated[0][1])} unmapped orientations "
        f"({out['genotype_cuda_s']:.2f} s on the card, "
        f"{out['genotype_cpu_s']:.2f} s on the CPU)")

    # timed: predict at GATE_ROWS rows, one Adam step on a batch of 10
    reps = -(-GATE_ROWS // x.shape[0])
    big = x.repeat(reps, 1)[:GATE_ROWS].contiguous()
    for second, model in models.items():
        ms = time_ms(lambda: dr.predict(model, big))
        bound, by = gate_bound_ms(model, GATE_ROWS)
        out[f"predict_ms_{second}"] = ms
        out[f"predict_bound_ms_{second}"] = bound
        out[f"predict_bound_by_{second}"] = by
    step_model = dr.RecruitmentMLP.from_numpy(models[0].to_numpy(), dev)
    opt = dr.adam(step_model)
    onehot = torch.as_tensor(np.stack([labels, 1 - labels], 1)[:10],
                             dtype=torch.float32, device=dev)
    out["adam_step_ms"] = time_ms(
        lambda: dr.adam_step(step_model, opt, x[:10], onehot))
    log(f"gate: predict at {GATE_ROWS} rows {out['predict_ms_0']:.4f} ms "
        f"(4096-100-2; bound {out['predict_bound_ms_0']:.4f} ms, "
        f"{out['predict_bound_by_0']}, reached "
        f"{out['predict_bound_ms_0'] / out['predict_ms_0']:.3f}), "
        f"{out['predict_ms_50']:.4f} ms with the 50-unit layer (bound "
        f"{out['predict_bound_ms_50']:.4f}); one Adam step at batch 10 "
        f"{out['adam_step_ms']:.4f} ms (CUDA events, medians of 10)")
    return out


def phase_addmodel(dev, kernels, tmp):
    """``addmodel --device cuda`` at full width, held to the plain twins
    on the card, and the new locus genotyped."""
    from advntr_tpu_torch.engine import device_analytics as da
    from advntr_tpu_torch.engine import finder as finder_mod
    from advntr_tpu_torch.engine import training
    from advntr_tpu_torch.io.fasta import load_chromosome
    from advntr_tpu_torch.models.db import load_unique_vntrs_data
    from advntr_tpu_torch.ops import viterbi_fused as vf
    from advntr_tpu_torch.synthetic import (write_addmodel_reference,
                                            write_diploid_bam)
    wd = os.path.join(tmp, "addmodel")
    os.makedirs(wd)
    fa, chrom, start, end, pattern = write_addmodel_reference(wd)
    db = os.path.join(wd, "models.db")
    spied = [(training, "find_recruitment_score_threshold"),
             (training, "simulate_false_filtered_reads"),
             (finder_mod, "build_locus_payload"),
             (finder_mod.VNTRFinder, "score_reads")]
    calls = {name: [] for _, name in spied}
    originals = [(obj, name, _spy(obj, name, calls[name]))
                 for obj, name in spied]
    orig_read_stats = da.read_stats
    try:
        before = dict(kernels.LAUNCHES)
        t0 = time.perf_counter()
        from advntr_tpu_torch import cli
        cli.main(["addmodel", "-r", fa, "-c", chrom, "-p", pattern, "-s",
                  str(start), "-e", str(end), "-g", "CSTB", "-a",
                  "Promoter", "-m", db, "--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: v - before[k] for k, v in kernels.LAUNCHES.items()}
        split = {name: sum(c[2] for c in got) for name, got in calls.items()}
        (_, decoys, _), = calls["simulate_false_filtered_reads"]
        for k in ILLUMINA_KERNELS:
            check(launches[k] > 0, f"addmodel never launched {k}")
        (ref,) = load_unique_vntrs_data(db)
        check(ref.get_repeat_segments() == [pattern] * 13
              and len(ref.left_flanking_region) == 500,
              f"addmodel: segments {ref.get_repeat_segments()}")
        fits = calls["find_recruitment_score_threshold"]
        (args, threshold, _), = fits
        true_k, false_k = args
        check(len(decoys) >= 5000, f"addmodel: the scan found {len(decoys)} "
                                   "decoys, not at least 5,000")
        # the same training with the plain twins on the card
        da.read_stats = lambda model, seqs, lengths, return_path=False, \
            **kw: vf.viterbi_stats_reference(model, seqs, lengths,
                                             return_path=return_path)
        t0 = time.perf_counter()
        twin_scaled = training.train_classifier_threshold(
            ref, load_chromosome(fa, chrom), READ_LEN, device=dev)
        twin_s = time.perf_counter() - t0
    finally:
        da.read_stats = orig_read_stats
        for obj, name, orig in originals:
            setattr(obj, name, orig)
    (args, twin_threshold, _) = fits[1]
    for what, got, want in (("true", true_k, args[0]),
                            ("decoy", false_k, args[1])):
        check(len(got) == len(want),
              f"addmodel: {len(got)} {what} scores with the kernels, "
              f"{len(want)} with the twins")
        check(np.allclose(got, want, **LOGP_TOL),
              f"addmodel: {what} scores differ from the twins' by "
              f"{np.abs(np.array(got) - np.array(want)).max()}")
    err = max(float(np.abs(np.array(a) - np.array(b)).max())
              for a, b in ((true_k, args[0]), (false_k, args[1])))
    check(threshold == twin_threshold,
          f"addmodel: threshold {threshold} with the kernels, "
          f"{twin_threshold} with the twins")
    check(ref.scaled_score == twin_scaled
          and ref.scaled_score == threshold / READ_LEN,
          f"addmodel: stored scaled_score {ref.scaled_score}, the twins' "
          f"{twin_scaled}")
    bam = os.path.join(wd, "sample.bam")
    write_diploid_bam(bam, ref, 2, 5, READ_LEN, 40, ref_length=2_000_000)
    text, gs = run_cli(["genotype", "-a", bam, "-m", db,
                        "--working_directory", wd, "--disable_logging",
                        "-o", os.path.join(wd, "out.txt"), "--device",
                        "cuda"])
    check(text.split() == [str(ref.id), "2/5"],
          f"addmodel's locus genotyped {text.split()}")
    out = {"wall_s": wall, "decoy_scan_s":
           split["simulate_false_filtered_reads"],
           "host_model_build_s": split["build_locus_payload"],
           "scoring_s": split["score_reads"], "true_reads": len(true_k),
           "decoys": len(decoys), "decoys_kept": len(false_k),
           "threshold": threshold,
           "scaled_score": ref.scaled_score, "twins_s": twin_s,
           "max_abs_logp_vs_twins": err, "launches": launches,
           "genotype_s": gs}
    log(f"addmodel --device cuda (read length {READ_LEN}, "
        f"{pattern} x 13, 2 Mb chromosome): {wall:.2f} s: decoy scan "
        f"{out['decoy_scan_s']:.2f} s, host model build "
        f"{out['host_model_build_s']:.2f} s, scoring {out['scoring_s']:.2f} "
        f"s ({len(decoys)} decoys found, {len(true_k)} true and "
        f"{len(false_k)} decoy reads kept); "
        f"launches {launches}; threshold {threshold} (scaled "
        f"{ref.scaled_score}) equal to the twins' on the card ({twin_s:.1f} "
        f"s), scores within {err:.3g}; the new locus genotyped 2/5 in "
        f"{gs:.2f} s")
    return out


def phase_trained_hmm(dev, tmp):
    """Trained-HMM JSON models on the card: the CSTB model imported as it
    is (structured) and a refused topology (the dense fallback)."""
    from advntr_tpu_torch.engine import device_analytics as da
    from advntr_tpu_torch.engine.finder import LocusModelCache, VNTRFinder
    from advntr_tpu_torch.models.compiler import compile_graph
    from advntr_tpu_torch.models.hmm_json import (
        graph_from_pomegranate_json, graph_to_pomegranate_json)
    from advntr_tpu_torch.ops import viterbi_fused as vf
    from advntr_tpu_torch.synthetic import (build_cstb_locus, encode_reads,
                                            refused_topology,
                                            simulate_cstb_reads,
                                            write_cstb_sample,
                                            write_trained_hmms)
    wd = os.path.join(tmp, "trained")
    os.makedirs(wd)
    db, bam = write_cstb_sample(wd, read_length=READ_LEN)
    same = write_trained_hmms(os.path.join(wd, "same"), db, READ_LEN)
    refused = write_trained_hmms(os.path.join(wd, "refused"), db, READ_LEN,
                                 refused=True)
    loaded, dense_calls = [], []
    orig_load = _spy(VNTRFinder, "_load_trained_hmm", loaded)
    orig_dense = _spy(da, "read_stats_dense", dense_calls)
    texts, secs = {}, {}
    try:
        for device in ("cuda", "cpu"):
            for name, hmms in (("plain", None), ("trained", same)):
                t0 = time.perf_counter()
                texts[name, device] = genotype_text(
                    db, bam, os.path.join(wd, f"{name}_{device}"), device,
                    trained_hmms_dir=hmms)
                secs[name, device] = time.perf_counter() - t0
        struct_on = {lm.model.device.type for _, lm, _ in loaded
                     if lm is not None and lm.model is not None}
        t0 = time.perf_counter()
        texts["dense", "cuda"] = genotype_text(
            db, bam, os.path.join(wd, "dense_cuda"), "cuda",
            trained_hmms_dir=refused)
        torch.cuda.synchronize()
        secs["dense", "cuda"] = time.perf_counter() - t0
    finally:
        VNTRFinder._load_trained_hmm = orig_load
        da.read_stats_dense = orig_dense
    want = texts["plain", "cuda"]
    check(want.split() == ["301645", "2/5"], f"CSTB at 150: {want.split()}")
    for key, text in texts.items():
        check(text == want, f"trained HMMs: {key} gives {text.split()}, "
                            f"without them {want.split()}")
    check(struct_on == {"cuda", "cpu"},
          f"trained HMMs: structured imports on {struct_on}, not on both "
          "devices")
    check(len(dense_calls) >= 1
          and all(args[1].is_cuda for args, _, _ in dense_calls),
          "the refused topology did not take the dense fallback on the "
          "card")
    log("trained HMMs: CSTB 2/5 at 150 bp with trained_hmms_dir equal to "
        "the text without it on the card and the CPU ("
        + ", ".join(f"{a} {b} {v:.2f} s" for (a, b), v in secs.items())
        + f"); the refused topology through the dense fallback on the card "
          f"({len(dense_calls)} calls): 2/5")

    # the dense fallback at B 256 on the card, 32 reads against the CPU
    graph, _, left, right, pattern = build_cstb_locus(READ_LEN)
    g = graph_from_pomegranate_json(
        graph_to_pomegranate_json(refused_topology(graph)))
    art = compile_graph(g)
    lm = LocusModelCache(device=dev)._build_imported(g, art)
    check(lm.model is None and lm.dense is not None,
          "the refused topology did not give a dense model")
    batch, lengths = encode_reads(
        simulate_cstb_reads(left, pattern, right, READ_LEN, DENSE_B, seed=9),
        READ_LEN)
    seqs = torch.as_tensor(batch, device=dev)
    lens = torch.as_tensor(lengths, device=dev)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    res = da.read_stats_dense(lm.dense, seqs, lens)
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 2**20
    ms = time_ms(lambda: da.read_stats_dense(lm.dense, seqs, lens),
                 iters=3, warmup=0)
    k = DENSE_CPU_READS
    host = LocusModelCache(device="cpu")._build_imported(g, art)
    want = da.read_stats_dense(host.dense, seqs[:k].cpu(), lens[:k].cpu())
    check(torch.allclose(res["logp"][:k].cpu(), want["logp"], **LOGP_TOL),
          "dense fallback: logp on the card differs from the CPU's")
    for key in vf.STAT_KEYS:
        check(torch.equal(res[key][:k].cpu(), want[key]),
              f"dense fallback: {key} on the card differs from the CPU's")
    check(bool(torch.isfinite(res["logp"]).all()),
          "dense fallback: logp not finite")
    n, L = lm.dense.n_states, seqs.shape[1]
    bound = 2 * DENSE_B * (L - 1) * n * n / 67e12 * 1e3
    err = float((res["logp"][:k].cpu() - want["logp"]).abs().max())
    out = {"dense_ms": ms, "dense_peak_mib": peak,
           "dense_B": DENSE_B, "dense_n": n, "dense_L": L,
           "dense_bound_ms": bound, "dense_bound_by": "operations",
           "dense_vs_cpu_max_abs_logp": err,
           "genotype_s": {f"{a}_{b}": v for (a, b), v in secs.items()}}
    log(f"dense fallback (B {DENSE_B}, n {n} padded, L {L}, rows in chunks "
        f"of {da.DENSE_CHUNK_BYTES // (4 * n * n)}): {ms:.3f} ms (median "
        f"of 3), peak {peak:.1f} MiB; bound {bound:.4f} ms (operations), "
        f"reached {bound / ms:.5f}; the first {k} reads' statistics equal "
        f"to the CPU's, max |logp diff| {err}")
    return out


def phase_buildbank(tmp, panel_text):
    """``buildbank -t 4`` on phase 5's panel, a warm genotype from it,
    then ``delmodel`` and ``viewmodel``."""
    import contextlib
    import io
    from advntr_tpu_torch import cli
    from advntr_tpu_torch.engine import finder as finder_mod
    from advntr_tpu_torch.models.db import load_unique_vntrs_data
    from advntr_tpu_torch.synthetic import write_panel
    wd = os.path.join(tmp, "bank")
    os.makedirs(wd)
    db, bam, truth = write_panel(wd, n_loci=PANEL_LOCI, read_length=150,
                                 coverage=30)
    refs = load_unique_vntrs_data(db)
    t0 = time.perf_counter()
    cli.main(["buildbank", "-m", db, "--working_directory", wd, "-l",
              "150", "-t", "4"])
    build_s = time.perf_counter() - t0
    bank = os.path.join(wd, "model_bank")
    names = {os.path.basename(finder_mod.bank_payload_path(
        bank, r.id, int(round(150 / len(r.pattern) + 0.5)), 150, 0.05))
        for r in refs}
    check(set(os.listdir(bank)) ==
          names | {finder_mod.dense_payload_path(n) for n in names},
          f"buildbank wrote {sorted(os.listdir(bank))[:3]}..., not the "
          "reference's file names and their dense tables' companions")
    builds = []
    orig = _spy(finder_mod, "build_locus_payload", builds)
    try:
        text, warm_s = run_cli(["genotype", "-a", bam, "-m", db,
                                "--working_directory", wd,
                                "--disable_logging", "-o",
                                os.path.join(wd, "out.txt"), "--device",
                                "cuda"])
    finally:
        finder_mod.build_locus_payload = orig
    check(not builds, f"warm genotype built {len(builds)} models on the "
                      "host despite the bank")
    check(text == panel_text, "genotype from the bank differs from phase "
                              "5's panel text")
    cli.main(["delmodel", "-vid", str(refs[0].id), "-m", db])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["viewmodel", "-m", db])
    listed = buf.getvalue().splitlines()[2:]
    check(len(listed) == PANEL_LOCI - 1
          and not any(line.startswith(f"{refs[0].id}\t") for line in listed),
          f"viewmodel lists {len(listed)} loci after delmodel")
    log(f"buildbank -t 4: {len(names)} payloads under the reference's "
        f"names in {build_s:.2f} s; warm genotype from the bank "
        f"{warm_s:.2f} s with no host model build, phase 5's text; "
        f"delmodel {refs[0].id}, viewmodel lists {len(listed)}")
    return {"build_s": build_s, "warm_genotype_s": warm_s,
            "payloads": len(names), "listed_after_delmodel": len(listed)}


def phase_model_management(dev, kernels, panel_text):
    """Phase 9, the model-management path: every kernel count starts at 0
    here and is read at the end (the twins launch none)."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_models_")
    try:
        kernels.reset_launches()
        gate = phase_gate(dev, tmp)
        addmodel = phase_addmodel(dev, kernels, tmp)
        trained = phase_trained_hmm(dev, tmp)
        bank = phase_buildbank(tmp, panel_text)
        launches = dict(kernels.LAUNCHES)
        log(f"model management (cuda): launches {launches}")
        for k in ILLUMINA_KERNELS:
            check(launches[k] > 0,
                  f"kernel {k} never launched on the model-management path")
        return {"gate": gate, "addmodel": addmodel, "trained": trained,
                "buildbank": bank, "launches": launches}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---- scale-out and the mutated-reference sweep (phase 10) -------------------

# the explicit splits of the group shape over one card: loci 2 x reads 1,
# and loci 8 x reads 2 (GROUP 8, rows 512)
ONE_CARD_SPLITS = (2, 16)
# the sweep at full width: the CSTB locus, 150 bp reads, coverage 30
SWEEP_COUNTS = (2, 5, 9)

# one process of a sharded panel: this process's loci, its launch counts,
# its start (imports and the device's context) and run seconds; process 0
# also the merged records.  The body runs under the __main__ guard: with
# io_threads 2 the model cache's build pool spawns, and each spawned
# child imports this file again as __mp_main__.
SHARDED_PANEL_WORKER = '''
import json, os, sys, time


def main():
    t0 = time.perf_counter()
    repo, db, bam, workdir, pid, nproc, device, io_threads = sys.argv[1:9]
    sys.path.insert(0, repo)
    import torch
    from advntr_tpu_torch.config import Config
    from advntr_tpu_torch.models.db import load_unique_vntrs_data
    from advntr_tpu_torch.ops import _kernels
    from advntr_tpu_torch.parallel.distributed import run_sharded_panel
    if device == "cuda":
        torch.cuda.init()
    pid, nproc = int(pid), int(nproc)
    refs = load_unique_vntrs_data(db)
    ids = [r.id for r in refs]
    t1 = time.perf_counter()
    _kernels.reset_launches()
    merged = run_sharded_panel(refs, ids, bam, workdir,
                               Config(io_threads=int(io_threads)),
                               process_id=pid, num_processes=nproc,
                               device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    t2 = time.perf_counter()
    with open(os.path.join(workdir, "worker_%d.json" % pid), "w") as fh:
        json.dump({"launches": _kernels.LAUNCHES, "merged": merged,
                   "start_s": t1 - t0, "run_s": t2 - t1}, fh)


if __name__ == "__main__":
    main()
'''


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def phase_sharded_dispatch(dev, kernels, group):
    """The group shape through ``sharded_grouped_read_stats``: explicit
    splits over this one card, and over every card where more than one is
    visible; each bit-identical to one unsharded launch, with one launch
    of each kernel a shard, timed against it."""
    from advntr_tpu_torch.engine import device_analytics as da
    from advntr_tpu_torch.parallel import mesh as pmesh
    stack, seqs, lens = group
    models, b_pad, card = stack.models, seqs.shape[1], seqs.device
    whole = da.read_stats_grouped(models, seqs, lens)
    sync(dev)
    splits = {f"{n} x {card}": [card] * n for n in ONE_CARD_SPLITS}
    cards = pmesh.visible_devices(dev.type)
    if len(cards) > 1:
        splits[f"{len(cards)} cards"] = cards
    out = {"unsharded_ms": time_ms(
        lambda: da.read_stats_grouped(models, seqs, lens))}
    for name, devices in splits.items():
        m = pmesh.panel_mesh(GROUP, b_pad, devices=devices)
        check(m is not None, f"no mesh for {name} at G {GROUP}, B {b_pad}")
        kernels.reset_launches()
        got = pmesh.sharded_grouped_read_stats(m, models, seqs, lens)
        sync(dev)
        launches = dict(kernels.LAUNCHES)
        shards = m.n_loci * m.n_reads
        check(dev.type != "cuda"
              or launches["forward"] == launches["backward"] == shards,
              f"{name}: launches {launches}, one of each kernel a shard "
              f"is {shards}")
        check(set(got) == set(whole)
              and all(torch.equal(got[k], whole[k]) for k in whole),
              f"{name}: sharded statistics differ from one launch")
        ms = time_ms(lambda: pmesh.sharded_grouped_read_stats(
            m, models, seqs, lens))
        out[name] = {"mesh": [m.n_loci, m.n_reads], "launches": launches,
                     "ms": ms}
        where = ("an explicit split over one card"
                 if len(set(devices)) == 1 else "one shard a card")
        log(f"sharded dispatch, {name} (loci {m.n_loci} x reads "
            f"{m.n_reads}, {where}): "
            f"bit-identical to one launch, {shards} launches of each "
            f"kernel, {ms:.3f} ms against {out['unsharded_ms']:.3f} ms "
            "unsharded")
    out["unsharded_ms_after"] = time_ms(
        lambda: da.read_stats_grouped(models, seqs, lens))
    if len(cards) > 1:
        from advntr_tpu_torch.ops.struct_model import TorchStructModel
        part = TorchStructModel.stack(models[:GROUP // 2])

        def copy():
            part.to(cards[1])
            torch.cuda.synchronize(cards[1])

        out["table_copy_ms"] = statistics.median(
            _wall_ms(copy) for _ in range(10))
        log(f"sharded dispatch: {GROUP // 2} loci's tables "
            f"{card} -> {cards[1]} {out['table_copy_ms']:.4f} ms")
    else:
        out["table_copy_ms"] = None
        log("sharded dispatch: one card visible, so no table copy between "
            "cards and no split over cards: not measured")
    return out


def stop(proc) -> None:
    """Kill a process started in a session of its own, with its group."""
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    proc.wait()


def _wall_ms(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def run_sharded_panel_processes(dev, db, bam, workdir, nproc, io_threads,
                                timeout=300):
    """``run_sharded_panel`` in ``nproc`` OS processes over one panel:
    {"merged": process 0's records, "launches": summed over the
    processes, "wall_s": the whole run, "start_s" and "run_s": each
    process's own}."""
    os.makedirs(workdir)
    script = os.path.join(workdir, "worker.py")
    with open(script, "w") as fh:
        fh.write(SHARDED_PANEL_WORKER)
    repo = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    # each process leads a process group of its own, so that its build
    # pool goes with it if it has to be stopped
    procs = [subprocess.Popen(
        [sys.executable, script, repo, db, bam, workdir, str(p), str(nproc),
         dev.type, str(io_threads)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, start_new_session=True)
        for p in range(nproc)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=timeout)
            check(p.returncode == 0,
                  f"sharded panel process failed ({p.returncode}): "
                  f"{err[-3000:]}")
    finally:
        for p in procs:
            stop(p)
    wall = time.perf_counter() - t0
    reports = []
    for p in range(nproc):
        with open(os.path.join(workdir, f"worker_{p}.json")) as fh:
            reports.append(json.load(fh))
    return {"merged": reports[0]["merged"], "wall_s": wall,
            "launches": {k: sum(r["launches"][k] for r in reports)
                         for k in reports[0]["launches"]},
            "start_s": [r["start_s"] for r in reports],
            "run_s": [r["run_s"] for r in reports]}


def record_text(rec) -> str:
    """A merged record as the text output prints its genotype."""
    if rec["error"]:
        return "Error"
    if rec["copy_numbers"] is None:
        return "None"
    return "/".join(str(c) for c in sorted(rec["copy_numbers"]))


# the sharded panel's runs: (processes, io_threads); io_threads 1 builds
# each locus model in the process, as the CLI does, 2 in one spawned
# worker a process, which is what needs the worker's __main__ guard
PANEL_RUNS = ((1, 1), (2, 1), (2, 2))


def phase_sharded_panel(dev, panel_text):
    """Phase 5's 24-locus panel through ``run_sharded_panel`` in one OS
    process and in two on this card, the models built in each process and
    in a spawned build worker: every run merges to the same records and to
    phase 5's genotypes."""
    from advntr_tpu_torch.synthetic import write_panel
    tmp = tempfile.mkdtemp(prefix="chip_smoke_sharded_")
    try:
        db, bam, _ = write_panel(tmp, n_loci=PANEL_LOCI, read_length=150,
                                 coverage=30)
        runs = {f"{n}p{io}t": run_sharded_panel_processes(
            dev, db, bam, os.path.join(tmp, f"p{n}t{io}"), n, io)
            for n, io in PANEL_RUNS}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    one = runs["1p1t"]["merged"]
    lines = panel_text.split()
    calls = dict(zip(lines[0::2], lines[1::2]))
    check({vid: record_text(rec) for vid, rec in one.items()} == calls,
          "the sharded panel's genotypes differ from phase 5's")
    for name, run in runs.items():
        check(run["merged"] == one,
              f"the panel's merged records in run {name} differ from one "
              "process's")
        for k in ILLUMINA_KERNELS:
            check(dev.type != "cuda" or run["launches"][k] > 0,
                  f"kernel {k} never launched by run {name}")
        fmt = lambda xs: ", ".join(f"{x:.2f}" for x in xs)
        log(f"sharded panel ({dev.type}), {name[0]} process(es), io_threads "
            f"{name[2]}: {PANEL_LOCI} loci in {run['wall_s']:.2f} s wall; "
            f"each process: start (imports, device context) "
            f"{fmt(run['start_s'])} s, run {fmt(run['run_s'])} s; "
            f"launches {run['launches']}")
    log("sharded panel: every run's merged records equal, phase 5's "
        "genotypes")
    return {name: {k: v for k, v in run.items() if k != "merged"}
            for name, run in runs.items()}


def phase_sweep(dev, kernels):
    """``mutated_reference_sweep`` on the card at full width, every row
    called (k, k), and the same sweep with a CPU finder on the same seed
    giving the same rows."""
    from advntr_tpu_torch.config import Config
    from advntr_tpu_torch.engine.evaluation import mutated_reference_sweep
    from advntr_tpu_torch.engine.finder import VNTRFinder
    from advntr_tpu_torch.synthetic import cstb_chromosome
    ref, chrom = cstb_chromosome()
    kw = dict(desired_counts=SWEEP_COUNTS, coverage=30, read_length=150,
              seed=0)
    finder = None if dev.type == "cuda" else VNTRFinder(ref, Config(),
                                                        device=dev)
    kernels.reset_launches()
    t0 = time.perf_counter()
    card = mutated_reference_sweep(ref, chrom, finder=finder, **kw)
    sync(dev)
    secs = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    for k in ILLUMINA_KERNELS:
        check(dev.type != "cuda" or launches[k] > 0,
              f"kernel {k} never launched by the sweep")
    for row in card["rows"]:
        check(row["called"] == (row["desired"], row["desired"]),
              f"sweep called {row}")
    t0 = time.perf_counter()
    cpu = mutated_reference_sweep(
        ref, chrom, finder=VNTRFinder(ref, Config(), device="cpu"), **kw)
    cpu_secs = time.perf_counter() - t0
    check(card["rows"] == cpu["rows"],
          f"sweep rows differ: {card['rows']} against the CPU's "
          f"{cpu['rows']}")
    log(f"sweep ({dev.type}): CSTB at 150 bp, coverage 30, counts "
        f"{list(SWEEP_COUNTS)}: every row (k, k), equal to the CPU "
        f"finder's rows; {secs:.2f} s (the CPU finder {cpu_secs:.2f} s); "
        f"launches {launches}; rows {card['rows']}")
    return {"s": secs, "cpu_s": cpu_secs, "launches": launches,
            "rows": card["rows"]}


def scale_launches(scale, kernel: str) -> dict:
    """A kernel's launches on phase 10's paths, for the kernels line."""
    split = f"{ONE_CARD_SPLITS[-1]} x "
    return {"sharded_dispatch_launches": next(
                v["launches"][kernel] for k, v in scale["dispatch"].items()
                if k.startswith(split)),
            "sharded_panel_launches":
                scale["panel"]["2p1t"]["launches"][kernel],
            "sweep_launches": scale["sweep"]["launches"][kernel]}


def phase_scale_out(dev, kernels, group, panel_text):
    """Phase 10: the sharded dispatch, the sharded panel and the sweep,
    each driven with every launch count set to 0 just before it and read
    just after."""
    t0 = time.perf_counter()
    out = {"dispatch": phase_sharded_dispatch(dev, kernels, group),
           "panel": phase_sharded_panel(dev, panel_text),
           "sweep": phase_sweep(dev, kernels)}
    out["phase_s"] = time.perf_counter() - t0
    log(f"phase 10: {out['phase_s']:.1f} s")
    return out


# ---- the structured decoder (phase 11) --------------------------------------

# the soak on the card: (widths of synthetic.soak_model, models, reads a
# model, first seed); the cell's width (P 512) and the long-read model's
# (P 2,560, reads past B1's whole-plane limit: both sides segmented)
STRUCT_SOAK = {"cell": ("SOAK_CELL", 6, 64, 100),
               "long": ("SOAK_LONG", 1, 32, 200)}
SOAK_TOL = dict(rel=1e-4, abs=2e-2)
# the cell's reads a model of the group shape (G 8 of the CSTB model)
STRUCT_GROUP_ROWS = 512
STRUCT_PANEL_TIMEOUT = 240


@contextlib.contextmanager
def kernel_env(kernel):
    """``ADVNTR_TPU_KERNEL`` set inside the block, put back after."""
    saved = os.environ.get("ADVNTR_TPU_KERNEL")
    os.environ["ADVNTR_TPU_KERNEL"] = kernel
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("ADVNTR_TPU_KERNEL", None)
        else:
            os.environ["ADVNTR_TPU_KERNEL"] = saved


def struct_contract(what, art, rows, struct, kern) -> dict:
    """B1/B2's results ``kern`` held to the structured decoder's
    ``struct`` under ROADMAP's contract: logp within rtol 1e-4 / atol
    1e-2; statistics equal on every row whose two paths are equal; where
    they differ (a tie), both paths rescore in float64 to the structured
    optimum.  Every structured path is rescored too."""
    from advntr_tpu_torch.ops.viterbi_fused import STAT_KEYS
    from advntr_tpu_torch.synthetic import rescore
    l1 = struct["logp"].cpu().numpy()
    l2 = kern["logp"].cpu().numpy()
    keep = l1 > -1e20
    check(np.allclose(l2[keep], l1[keep], **LOGP_TOL),
          f"{what}: kernels' logp differs from the structured path's")
    p1, p2 = struct["path"].cpu().numpy(), kern["path"].cpu().numpy()
    stats = {k: (struct[k].cpu().numpy(), kern[k].cpu().numpy())
             for k in STAT_KEYS}
    ties = rescored = 0
    worst = 0.0
    for b, codes in enumerate(rows):
        if not keep[b]:
            continue
        n = len(codes)
        paths = [p1[b, :n]]
        if np.array_equal(p1[b, :n], p2[b, :n]):
            bad = [k for k, (x, y) in stats.items() if x[b] != y[b]]
            check(not bad, f"{what}: row {b} has equal paths and other "
                           f"statistics {bad}")
        else:
            ties += 1
            paths.append(p2[b, :n])
        for path in paths:
            score = rescore(art, path, codes)
            rescored += 1
            err = abs(score - float(l1[b]))
            worst = max(worst, err)
            check(err <= SOAK_TOL["abs"] + SOAK_TOL["rel"] * abs(score),
                  f"{what}: row {b}'s path rescores to {score}, the "
                  f"optimum is {l1[b]}")
    return {"rows": int(keep.sum()), "tie_rows": ties,
            "rescored_f64": rescored, "max_rescore_err": worst,
            "max_abs_err": float(np.abs(l2[keep] - l1[keep]).max())}


def struct_bitwise(dev) -> dict:
    """The structured decoder on the card against the CPU, bit for bit:
    the CSTB cell's model, 64 of its reads, every statistic and path."""
    from advntr_tpu_torch.engine import device_analytics as da
    from advntr_tpu_torch.ops.struct_model import TorchStructModel
    from advntr_tpu_torch.ops.viterbi_struct import StructDeviceModel
    from advntr_tpu_torch.synthetic import (build_cstb_locus, encode_reads,
                                            padded_structured,
                                            simulate_cstb_reads)
    graph, art, left, right, pattern = build_cstb_locus(READ_LEN)
    sm = padded_structured(graph, art, pos_bucket=128)
    reads = simulate_cstb_reads(left, pattern, right, READ_LEN, 64, seed=9)
    batch, lengths = encode_reads(reads, READ_LEN)
    out = {}
    for d in (dev, torch.device("cpu")):
        meta = TorchStructModel.from_payload(art, sm, d).art_meta
        out[d.type] = da.read_stats_struct(
            StructDeviceModel.from_struct(sm, art, d), meta,
            torch.as_tensor(batch, device=d),
            torch.as_tensor(lengths, device=d), sm.suffix_last,
            return_path=True)
    for k, v in out["cpu"].items():
        check(torch.equal(out[dev.type][k].cpu(), v),
              f"structured path: {k} on {dev.type} differs from the CPU")
    log(f"struct bitwise: CSTB model (P {sm.P}), 64 reads: logp, paths and "
        f"every statistic on {dev.type} bit-identical to the CPU")
    return {"rows": len(reads)}


def struct_soak(dev) -> dict:
    """The soak at full width on the card: random models of the cell's
    and the long-read model's widths; B1/B2 held to the structured path
    under the contract (whole reads at the cell's width; the long-read
    width through both checkpointed paths, segments of LONG_K)."""
    import random

    from advntr_tpu_torch import dna, synthetic
    from advntr_tpu_torch.engine import device_analytics as da
    from advntr_tpu_torch.ops.struct_model import TorchStructModel
    from advntr_tpu_torch.ops.viterbi_struct import StructDeviceModel
    out = {}
    for name, (widths, n_models, n_reads, seed0) in STRUCT_SOAK.items():
        widths = getattr(synthetic, widths)
        total = {"models": 0, "P": set(), "rows": 0, "tie_rows": 0,
                 "rescored_f64": 0, "max_rescore_err": 0.0,
                 "max_abs_err": 0.0}
        for i in range(n_models):
            rng = random.Random(seed0 + i)
            err = (0.05, 0.3)[i % 2]
            _, art, sm, left, pattern, right, copies = synthetic.soak_model(
                rng, err, **widths)
            reads = [synthetic.soak_read(rng, left, pattern, right, copies)
                     for _ in range(n_reads)]
            rows = [dna.encode(r) for r in reads]
            batch, lengths = dna.pad_batch(rows, multiple=32)
            q = torch.as_tensor(batch, device=dev)
            n = torch.as_tensor(lengths, device=dev)
            tm = TorchStructModel.from_payload(art, sm, dev)
            sdm = StructDeviceModel.from_struct(sm, art, dev)
            if name == "long":
                struct = da.read_stats_struct_ckpt(
                    sdm, tm.art_meta, q, n, sm.suffix_last,
                    return_path=True, segment=LONG_K)
                kern = da.read_stats_ckpt(tm, q, n, return_path=True,
                                          segment=LONG_K)
            else:
                struct = da.read_stats_struct(sdm, tm.art_meta, q, n,
                                              sm.suffix_last,
                                              return_path=True)
                kern = da.read_stats(tm, q, n, return_path=True)
            sync(dev)
            got = struct_contract(f"soak {name} model {i}", art, rows,
                                  struct, kern)
            total["models"] += 1
            total["P"].add(sm.P)
            for k in ("rows", "tie_rows", "rescored_f64"):
                total[k] += got[k]
            for k in ("max_rescore_err", "max_abs_err"):
                total[k] = max(total[k], got[k])
        total["P"] = sorted(total["P"])
        out[name] = total
        log(f"struct soak ({name} width): {total['models']} models, P "
            f"{total['P']}, {total['rows']} rows, {total['tie_rows']} tie "
            f"rows, {total['rescored_f64']} paths rescored on the host in "
            f"float64 (largest gap to the optimum "
            f"{total['max_rescore_err']:.3g}); max |logp - struct| "
            f"{total['max_abs_err']:.3g}")
    return out


def start_struct_panel_cpu(db, bam, workdir):
    """``genotype`` with ADVNTR_TPU_KERNEL=struct --device cpu on the
    panel in a process of its own (it runs while the card works), in a
    session of its own so that its build pool goes with it."""
    os.makedirs(workdir)
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, ADVNTR_TPU_KERNEL="struct", PYTHONPATH=repo,
               OMP_NUM_THREADS="6")
    out = os.path.join(workdir, "out.txt")
    proc = subprocess.Popen(
        [sys.executable, "-m", "advntr_tpu_torch.cli", "genotype", "-a",
         bam, "-m", db, "--working_directory", workdir, "--disable_logging",
         "-o", out, "--device", "cpu"], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, start_new_session=True, env=env)
    return proc, out, time.perf_counter()


def struct_cli(dev, kernels, tmp, panel, panel_text) -> dict:
    """``genotype`` under ADVNTR_TPU_KERNEL=struct on the card against
    --device cpu and the default kernel: the CSTB fixture and the
    24-locus panel.  The struct runs launch neither kernel."""
    from advntr_tpu_torch.synthetic import write_cstb_sample
    cstb_db, cstb_bam = write_cstb_sample(tmp)

    def argv(db, bam, wd, device):
        os.makedirs(wd)
        return ["genotype", "-a", bam, "-m", db, "--working_directory",
                wd, "--disable_logging", "-o", os.path.join(wd, "out.txt"),
                "--device", device]

    texts, secs = {}, {}
    texts["cstb_default"], secs["cstb_default"] = run_cli(
        argv(cstb_db, cstb_bam, os.path.join(tmp, "cstb_default"), dev.type))
    kernels.reset_launches()
    with kernel_env("struct"):
        for name, (db, bam) in (("cstb", (cstb_db, cstb_bam)),
                                ("panel", panel)):
            texts[name], secs[name] = run_cli(
                argv(db, bam, os.path.join(tmp, name + "_struct"), dev.type))
        launches = dict(kernels.LAUNCHES)
        texts["cstb_cpu"], secs["cstb_cpu"] = run_cli(
            argv(cstb_db, cstb_bam, os.path.join(tmp, "cstb_cpu"), "cpu"))
    check(not any(launches.values()),
          f"the struct runs launched kernels: {launches}")
    check(texts["cstb"] == texts["cstb_cpu"] == texts["cstb_default"],
          "CSTB: struct text on the card differs from --device cpu's or "
          "the default kernel's")
    check(texts["cstb"].split() == ["301645", "2/5"],
          f"CSTB struct call {texts['cstb'].split()}")
    check(texts["panel"] == panel_text,
          "panel: struct text on the card differs from the default's")
    log(f"struct CLI: CSTB 2/5 on the card ({secs['cstb']:.2f} s), equal "
        f"to --device cpu ({secs['cstb_cpu']:.2f} s) and to the default "
        f"kernel; the {PANEL_LOCI}-locus panel on the card "
        f"{secs['panel']:.2f} s cold, equal to the default's text; "
        f"launches {launches}")
    return {"s": secs, "launches": launches}


def struct_launches(dev, fn) -> int:
    """Device operations (kernels, copies, fills) one call of ``fn``
    enqueues, as torch.profiler counts them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if dev.type != "cuda":
        return 0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        sync(dev)
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA)


def struct_timed(dev, fn, iters, warmup=1) -> tuple[float, float]:
    """(median ms of ``iters`` event-timed calls after ``warmup``, peak
    MiB above what was allocated before)."""
    sync(dev)
    base = torch.cuda.memory_allocated() if dev.type == "cuda" else 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    ms = time_ms(fn, iters=iters, warmup=warmup)
    peak = (torch.cuda.max_memory_allocated() - base) / 2**20 \
        if dev.type == "cuda" else 0.0
    return ms, peak


def struct_timing(dev) -> dict:
    """The structured decoder timed by CUDA events at the cell (B 4096,
    L 160), at the group shape (the CSTB model x 8, B 512 each) and on the
    long-read batch (B 64, L 2,432, P 2,560) through
    read_stats_struct_ckpt, each with its launches a call and peak MiB;
    the long-read batch also held to B1/B2's checkpointed path."""
    from advntr_tpu_torch.engine import device_analytics as da
    from advntr_tpu_torch.engine.finder import LocusModelCache
    from advntr_tpu_torch.models.struct_compiler import build_structured
    from advntr_tpu_torch.ops.struct_model import TorchStructModel
    from advntr_tpu_torch.ops.viterbi_struct import StructDeviceModel
    from advntr_tpu_torch.synthetic import (build_cstb_locus,
                                            build_long_read_locus,
                                            encode_reads, padded_structured,
                                            simulate_cstb_reads,
                                            simulate_long_reads)
    out = {}
    graph, art, left, right, pattern = build_cstb_locus(READ_LEN)
    sm = padded_structured(graph, art, pos_bucket=128)
    reads = simulate_cstb_reads(left, pattern, right, READ_LEN, N_READS,
                                seed=9)
    batch, lengths = encode_reads(reads, READ_LEN)
    q = torch.as_tensor(batch, device=dev)
    n = torch.as_tensor(lengths, device=dev)
    m = StructDeviceModel.from_struct(sm, art, dev)
    meta = TorchStructModel.from_payload(art, sm, dev).art_meta
    cell = lambda: da.read_stats_struct(m, meta, q, n, sm.suffix_last)
    G, rows = GROUP, STRUCT_GROUP_ROWS
    gm = StructDeviceModel.stack([m] * G)
    gmeta = da.stack_meta([meta] * G)
    gq, gn = q[:G * rows].reshape(G, rows, -1), n[:G * rows].reshape(G, rows)
    gsl = torch.full((G,), sm.suffix_last, device=dev)
    group = lambda: da.read_stats_struct_grouped(gm, gmeta, gq, gn, gsl)
    for name, fn, iters in (("cell", cell, 3), ("group", group, 3)):
        ms, peak = struct_timed(dev, fn, iters)
        out[name] = {"ms": ms, "peak_mib": peak,
                     "launches": struct_launches(dev, fn)}
    del gm, gq, gn
    # the long-read batch, the model padded as the engine pads it
    graph, art, rng, hap = build_long_read_locus(LONG_L)
    with kernel_env("struct"):
        lm = LocusModelCache(device=dev)._build_from_payload(
            art, build_structured(graph, art))
    t0 = time.perf_counter()
    lsm = lm.struct_model()
    sync(dev)
    build_s = time.perf_counter() - t0
    reads = simulate_long_reads(rng, hap, LONG_B, LONG_L)
    batch, lengths = encode_reads(reads, LONG_L)
    lq = torch.as_tensor(batch, device=dev)
    ln = torch.as_tensor(lengths, device=dev)
    res = {}

    def long_batch():
        res["struct"] = da.read_stats_struct_ckpt(
            lsm, lm.model.art_meta, lq, ln, lm.sm.suffix_last,
            return_path=True, segment=LONG_K)

    ms, peak = struct_timed(dev, long_batch, iters=1, warmup=0)
    cut = 128
    launches_cut = struct_launches(dev, lambda: da.read_stats_struct_ckpt(
        lsm, lm.model.art_meta, lq[:, :cut], ln.clamp(max=cut),
        lm.sm.suffix_last, segment=cut // 2))
    kern = da.read_stats_ckpt(lm.model, lq, ln, return_path=True,
                              segment=LONG_K)
    sync(dev)
    contract = struct_contract("long-read batch", art,
                               [b[:k] for b, k in zip(batch, lengths)],
                               res["struct"], kern)
    out["long"] = {"ms": ms, "peak_mib": peak, "P": lm.sm.P,
                   "n_states": art.n_states, "S": 2 * lm.sm.P + lm.sm.nb,
                   "table_build_s": build_s,
                   f"launches_first_{cut}_columns": launches_cut,
                   "reads_per_s": LONG_B / (ms / 1e3), **contract}
    log(f"struct timing: cell (B {N_READS}, L {L_PAD}, P {sm.P}) "
        f"{out['cell']['ms']:.3f} ms, {out['cell']['launches']} launches, "
        f"peak {out['cell']['peak_mib']:.1f} MiB; group (G {G}, B {rows}) "
        f"{out['group']['ms']:.3f} ms, {out['group']['launches']} launches, "
        f"peak {out['group']['peak_mib']:.1f} MiB; long-read batch (B "
        f"{LONG_B}, L {LONG_L}, P {lm.sm.P}, K {LONG_K}) {ms:.1f} ms "
        f"({LONG_B / (ms / 1e3):.1f} reads/s), peak {peak:.1f} MiB, "
        f"{launches_cut} launches over its first {cut} columns "
        f"(K {cut // 2}); its (S, S) table built in {build_s:.2f} s; "
        f"B1/B2 held to it: {contract}")
    return out


def c4_check(dev) -> str:
    """C-4: with cuda:0 current, each kernel handed cuda:1's tensors gives
    cuda:0's results bit for bit (run where more than one card is
    visible)."""
    from advntr_tpu_torch import dna
    from advntr_tpu_torch.ops import _kernels
    from advntr_tpu_torch.ops.struct_model import TorchStructModel
    from advntr_tpu_torch.synthetic import (build_cstb_locus, encode_reads,
                                            padded_structured,
                                            simulate_cstb_reads)
    if dev.type != "cuda" or torch.cuda.device_count() < 2:
        return "not run: one card"
    graph, art, left, right, pattern = build_cstb_locus(READ_LEN)
    sm = padded_structured(graph, art, pos_bucket=128)
    reads = simulate_cstb_reads(left, pattern, right, READ_LEN, 256, seed=9)
    batch, lengths = encode_reads(reads, READ_LEN)
    probe = torch.as_tensor(dna.encode(left[-60:]))[None]
    out = {}
    for index in (0, 1):
        d = torch.device("cuda", index)
        with torch.cuda.device(0):
            s = TorchStructModel.from_payload(art, sm, d).as_stack()
            q = torch.as_tensor(batch, device=d)[None]
            n = torch.as_tensor(lengths, device=d)[None]
            fwd = _kernels.forward(s, q, n)
            wide = _kernels.forward(s, q, n, wide=True)
            walk = _kernels.backward(s, n, *fwd[1:])
            align = _kernels.local_align_passes(q, n[0], probe.to(d),
                                                [60], [0])
        torch.cuda.synchronize(d)
        out[index] = [x.cpu() for x in (*fwd, *wide, *walk, *align)]
    check(all(torch.equal(a, b) for a, b in zip(out[0], out[1])),
          "C-4: kernels on cuda:1 with cuda:0 current differ from cuda:0's")
    return "cuda:1 with cuda:0 current bit-identical to cuda:0"


def phase_struct(dev, kernels, panel_text) -> dict:
    """Phase 11: the structured decoder (ADVNTR_TPU_KERNEL=struct, plain
    PyTorch): on the card against the CPU, the soak at full width with
    B1/B2 held to it, genotype text, times; the C-4 check."""
    from advntr_tpu_torch.synthetic import write_panel
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_struct_")
    proc = None
    try:
        db, bam, _ = write_panel(tmp, n_loci=PANEL_LOCI, read_length=150,
                                 coverage=30)
        proc, cpu_out, cpu_t0 = start_struct_panel_cpu(
            db, bam, os.path.join(tmp, "panel_cpu"))
        marks = {}
        mark = lambda name: marks.setdefault(name, round(
            time.perf_counter() - t0, 1))
        out = {"bitwise": struct_bitwise(dev), "marks_s": marks}
        mark("bitwise")
        out["soak"] = struct_soak(dev)
        mark("soak")
        out["cli"] = struct_cli(dev, kernels, tmp, (db, bam), panel_text)
        mark("cli")
        # the CPU run ends before the timed runs, which it would slow
        _, err = proc.communicate(timeout=STRUCT_PANEL_TIMEOUT)
        check(proc.returncode == 0,
              f"struct panel --device cpu failed: {err[-3000:]}")
        out["cli"]["s"]["panel_cpu"] = time.perf_counter() - cpu_t0
        with open(cpu_out) as fh:
            check(fh.read() == panel_text,
                  "panel: struct text with --device cpu differs from the "
                  "card's")
        log(f"struct CLI: the panel with --device cpu (its own process, "
            f"beside the card's work) equal, "
            f"{out['cli']['s']['panel_cpu']:.1f} s")
        mark("panel_cpu")
        out["timing"] = struct_timing(dev)
        mark("timing")
        out["c4"] = c4_check(dev)
        log(f"C-4: {out['c4']}")
    finally:
        if proc is not None:
            stop(proc)
        shutil.rmtree(tmp, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t0
    log(f"phase 11: {out['phase_s']:.1f} s (ends of its steps, s: "
        f"{out['marks_s']})")
    return out


def run_cli(argv) -> tuple[str, float]:
    from advntr_tpu_torch import cli
    t0 = time.perf_counter()
    cli.main(argv)
    if "cuda" in argv:
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    with open(argv[argv.index("-o") + 1]) as fh:
        return fh.read(), dt


def stage_totals() -> str:
    """Each span's seconds over its count, summed over the genotype calls
    since ``reset_stages`` and the spans outside a call."""
    from advntr_tpu_torch.utils import profiler
    totals: dict = {}
    for t in profiler.finished_calls() + [profiler.ambient()]:
        for name, (n, secs, _) in t.spans.items():
            row = totals.setdefault(name, [0, 0.0])
            row[0] += n
            row[1] += secs
    return ", ".join(f"{k} {v:.3f} s over {n} calls"
                     for k, (n, v) in sorted(totals.items(),
                                             key=lambda kv: -kv[1][1]))


def reset_stages() -> None:
    from advntr_tpu_torch.utils import profiler
    profiler.reset()


def profiled(fn):
    """Run ``fn`` under torch.profiler; print its wall time, the device
    time per kernel and the device's idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    reset_stages()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per_kernel = {}
    for evt in prof.key_averages():
        # a host op's device time repeats that of the kernels it launched
        if evt.device_type != DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0)
        if us > 0:
            per_kernel[evt.key] = (us, evt.count)
    busy = sum(us for us, _ in per_kernel.values()) / 1e6
    log(f"profile: wall {wall:.3f} s, device busy {busy * 1e3:.3f} ms, "
        f"idle share {1 - busy / wall:.4f}")
    for key, (us, n) in sorted(per_kernel.items(), key=lambda kv: -kv[1][0]):
        log(f"profile:   {us / 1e3:.3f} ms over {n} launches: {key[:90]}")
    log(f"profile: stages: {stage_totals()}")
    return out


def phase_end_to_end(kernels, profile: bool):
    from advntr_tpu_torch.synthetic import write_cstb_sample, write_panel
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        panel_db, panel_bam, truth = write_panel(
            tmp, n_loci=PANEL_LOCI, read_length=150, coverage=30)
        cstb_db, cstb_bam = write_cstb_sample(tmp)

        def argv(db, bam, wd, device):
            os.makedirs(wd, exist_ok=True)
            return ["genotype", "-a", bam, "-m", db, "--working_directory",
                    wd, "--disable_logging", "-o",
                    os.path.join(wd, "out.txt"), "--device", device]

        jobs = {"panel": (panel_db, panel_bam), "cstb": (cstb_db, cstb_bam)}
        # the main path: every kernel count starts at 0 right here
        kernels.reset_launches()
        gpu, secs = {}, {}
        for name, (db, bam) in jobs.items():
            reset_stages()
            gpu[name], secs[name] = run_cli(
                argv(db, bam, os.path.join(tmp, name + "_cuda"), "cuda"))
            if name == "panel":
                log(f"panel cold (cuda) stages: {stage_totals()}")
        launches = dict(kernels.LAUNCHES)
        log(f"end to end (cuda): launches {launches}")
        for k in ILLUMINA_KERNELS:
            check(launches[k] > 0,
                  f"kernel {k} never launched on the main path")
        # warm rerun on the bank the first run wrote (no host model build)
        wd = os.path.join(tmp, "panel_cuda")
        warm_argv = argv(panel_db, panel_bam, wd, "cuda")

        def warm_run():
            os.remove(os.path.join(wd, "results_checkpoint_panel.bam.jsonl"))
            return run_cli(warm_argv)

        kernels.reset_launches()
        warm, warm_s = warm_run()
        warm_launches = dict(kernels.LAUNCHES)
        check(warm == gpu["panel"], "warm panel rerun differs")
        log(f"warm panel: launches {warm_launches} for {PANEL_LOCI} loci")
        for k in ILLUMINA_KERNELS:
            n = warm_launches[k]
            check(0 < n <= MAX_GROUP_LAUNCHES,
                  f"warm panel launched {k} {n} times: once per locus "
                  f"group is at most {MAX_GROUP_LAUNCHES}")
        if profile:
            check(profiled(warm_run)[0] == gpu["panel"],
                  "profiled warm panel rerun differs")
        cpu = {name: run_cli(argv(db, bam, os.path.join(tmp, name + "_cpu"),
                                  "cpu"))[0]
               for name, (db, bam) in jobs.items()}
        for name in jobs:
            check(gpu[name] == cpu[name],
                  f"{name}: --device cuda output differs from --device cpu")
        check(gpu["cstb"].split() == ["301645", "2/5"],
              f"CSTB called {gpu['cstb'].split()}, expected 2/5")
        lines = gpu["panel"].split()
        calls = dict(zip(lines[0::2], lines[1::2]))
        right = sum(calls.get(str(v)) == "%d/%d" % ab
                    for v, ab in truth.items())
        n = len(truth)
        check(right == n,
              f"panel: {right}/{n} loci equal to the simulated genotype")
        log(f"end to end: CSTB 2/5; panel {right}/{n} loci equal to the "
            f"simulated genotype; cuda == cpu outputs")
        log(f"panel: {n} loci in {secs['panel']:.2f} s cold "
            f"({n / secs['panel']:.3f} loci/s, host model builds included), "
            f"{warm_s:.2f} s warm from the bank ({n / warm_s:.3f} loci/s)")
        return launches, warm_launches, gpu["panel"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> None:
    profile = "--profile" in sys.argv[1:]
    long_tail = "--long-tail" in sys.argv[1:]
    flag = lambda name: sys.argv[sys.argv.index(name) + 1].split(",") \
        if name in sys.argv[1:] else []
    sources = flag("--walk-source")
    align_sources = flag("--align-source")
    forward_sources = flag("--forward-source")
    forward_variants = flag("--forward-variant")
    smi = phase_device()
    dev = torch.device("cuda")
    from advntr_tpu_torch.ops import _kernels
    phase_build(_kernels)
    builds = variants = None
    if forward_sources or forward_variants:
        builds, variants = forward_builds(_kernels, forward_sources,
                                          forward_variants)
    m, seqs, lens, (b1_err, b2_err, rs_err) = phase_kernels(dev)
    group = phase_group(dev)
    ms = phase_timing(m, seqs, lens, group)
    if builds:
        phase_forward_sources(_kernels, builds, variants, m, seqs, lens)
    walk = phase_walk(_kernels, m, seqs, lens, group, sources)
    phase_recruitment(dev)
    launches, warm_launches, panel_text = phase_end_to_end(_kernels,
                                                           profile)
    wide_err = phase_wide_vs_twins(dev, _kernels)
    units_off = phase_wide_units_off(dev, _kernels)
    long_ = phase_long_reads(dev, _kernels, (m, seqs, lens), LONG_L, LONG_B)
    del seqs, lens
    if builds:
        phase_wide_sources(_kernels, builds, variants, long_["segment"])
    del long_["segment"]
    align_ = phase_local_align(dev, _kernels, align_sources)
    pacbio_launches = phase_pacbio_cli(_kernels)
    a10 = phase_update_frameshift(dev, _kernels)
    models = phase_model_management(dev, _kernels, panel_text)
    scale = phase_scale_out(dev, _kernels, group, panel_text)
    del group
    struct = phase_struct(dev, _kernels, panel_text)
    tail = None
    if long_tail:
        tail = phase_long_reads(dev, _kernels, None, TAIL_L, TAIL_B,
                                tail=True)
        if builds:
            phase_wide_sources(_kernels, builds, variants, tail["segment"])
        del tail["segment"]
    kernels = [
        {"name": "viterbi_forward", "route": "cuda",
         "source": "advntr_tpu_torch/csrc/viterbi_forward.cu",
         "replaces": "advntr_tpu/ops/pallas_viterbi.py:554",
         "launches": launches["forward"], "max_abs_err": b1_err,
         "ms": ms["B1"][0], "plain_ms": ms["B1"][1],
         "bound_ms": ms["bound"]["B1"][0],
         "bound_by": ms["bound"]["B1"][1], "library_ms": None,
         "warm_panel_launches": warm_launches["forward"],
         "update_frameshift_launches": a10["launches"]["forward"],
         "model_management_launches": models["launches"]["forward"],
         "addmodel_launches": models["addmodel"]["launches"]["forward"],
         **scale_launches(scale, "forward"),
         "group_ms": ms["group"]["B1"],
         "group_bound_ms": ms["group"]["B1_bound"]},
        {"name": "viterbi_backward", "route": "cuda",
         "source": "advntr_tpu_torch/csrc/viterbi_backward.cu",
         "replaces": "advntr_tpu/ops/pallas_viterbi.py:766",
         "launches": launches["backward"], "max_abs_err": b2_err,
         "ms": walk["cell"]["ms"], "plain_ms": ms["B2"][1],
         "bound_ms": ms["bound"]["B2"][0],
         "bound_by": ms["bound"]["B2"][1], "library_ms": None,
         "warm_panel_launches": warm_launches["backward"],
         "update_frameshift_launches": a10["launches"]["backward"],
         "update_frameshift_path_decodes": a10["path_decodes"],
         "model_management_launches": models["launches"]["backward"],
         "addmodel_launches": models["addmodel"]["launches"]["backward"],
         **scale_launches(scale, "backward"),
         "wrapper_ms": ms["B2"][0], "path_ms": walk["cell"]["ms_path"],
         "chain_floor_ms": walk["cell"]["floor_ms"],
         "windows_per_read": walk["cell"]["windows_mean"],
         "group_ms": walk["group"]["ms"],
         "group_wrapper_ms": ms["group"]["B2"],
         "group_bound_ms": ms["group"]["B2_bound"],
         "group_chain_floor_ms": walk["group"]["floor_ms"],
         "group_windows_per_read": walk["group"]["windows_mean"],
         "long_read_panel_launches": pacbio_launches["backward"],
         "long_read_launches_a_batch": long_["launches"]["backward"],
         "long_read_segment_ms": long_["b2_ms"],
         "long_read_segment_wrapper_ms": long_["b2_wrapper_ms"],
         "long_read_segment_bound_ms": long_["b2_bound_ms"],
         "long_read_segment_plain_ms": long_["b2_plain_ms"],
         "long_read_segment_max_abs_err": long_["b2_err"]},
        # B1's second entry: every number of the row at one 512-column
        # segment of the long-read batch (B 64, P 2,560) with planes, the
        # error and the twin's time over that whole segment; launches: the
        # long-read panel
        {"name": "viterbi_forward_wide", "route": "cuda",
         "source": "advntr_tpu_torch/csrc/viterbi_forward.cu",
         "replaces": "advntr_tpu/ops/pallas_viterbi.py:554",
         "launches": pacbio_launches["forward_wide"],
         "max_abs_err": long_["b1_err"], "ms": long_["b1_ms"],
         "plain_ms": long_["b1_plain_ms"],
         "bound_ms": long_["b1_bound_ms"],
         "bound_by": long_["b1_bound_by"], "library_ms": None,
         "cluster": long_["cluster"], "slice": long_["slice"],
         "max_active_clusters": long_["max_active_clusters"],
         "threads": long_["threads"], "smem_bytes": long_["smem_bytes"],
         "registers": long_["registers"], "spill_bytes": long_["spill_bytes"],
         "no_planes_ms": long_["b1_bare_ms"],
         "no_planes_bound_ms": long_["b1_bare_bound_ms"],
         "launches_a_batch": long_["launches"]["forward_wide"],
         "batch_ms": long_["ms_batch"],
         "batch_bound_ms": long_["batch_bound_ms"],
         "batch_peak_mib": long_["peak_mib"],
         "check_shape_max_abs_err": wide_err,
         "units_in_device_memory": units_off,
         "cell_ms": ms["B1_wide_at_cell"][1],
         "cell_first_entry_ms": ms["B1_wide_at_cell"][0],
         "long_read_panel_first_entry_launches": pacbio_launches["forward"]},
        # not a TPU kernel in the reference: the scan of
        # advntr_tpu/ops/align.py:71 is plain XLA there; at B 64, L 3,008
        {"name": "local_align", "route": "cuda",
         "source": "advntr_tpu_torch/csrc/local_align.cu",
         "replaces": "advntr_tpu/ops/align.py:71",
         "launches": pacbio_launches["local_align"],
         "max_abs_err": max(a["err"] for a in align_.values()),
         "ms": align_[3008]["ms"], "plain_ms": align_[3008]["plain_ms"],
         "bound_ms": align_[3008]["bound_ms"], "bound_by": "operations",
         "library_ms": None, "wrapper_ms": align_[3008]["wrapper_ms"],
         "chunks": align_[3008]["chunks"],
         "step_ns": align_[3008]["step_ns"],
         "chain_floor_ms": align_[3008]["chain_floor_ms"],
         "four_passes_ms": align_[3008]["passes_ms"],
         "four_passes_bound_ms": align_[3008]["passes_bound_ms"],
         "in_turns_ms": align_[3008]["in_turns"],
         "ms_12288": align_[12288]["ms"],
         "plain_ms_12288": align_[12288]["plain_ms"],
         "bound_ms_12288": align_[12288]["bound_ms"],
         "chunks_12288": align_[12288]["chunks"],
         "chain_floor_ms_12288": align_[12288]["chain_floor_ms"],
         "four_passes_ms_12288": align_[12288]["passes_ms"],
         "in_turns_ms_12288": align_[12288]["in_turns"]},
    ]
    if tail is not None:
        kernels[2]["tail"] = tail
    log("posterior and Baum-Welch (plain PyTorch, no kernel of their own): "
        + json.dumps({k: a10[k] for k in ("posterior", "baum_welch",
                                          "fs150_s", "em150_s",
                                          "em150_launches")}))
    log("model management (plain PyTorch beside B1/B2): " + json.dumps(
        {k: models[k] for k in ("gate", "addmodel", "trained",
                                "buildbank")}))
    log("scale-out and sweep (B1/B2 through the mesh, the processes and "
        "the finder): " + json.dumps(scale))
    log("structured decoder (plain PyTorch, no kernel of its own): "
        + json.dumps(struct))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
