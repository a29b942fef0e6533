"""The port's scale-out over processes (advntr_tpu_torch/parallel/
distributed.py) against the reference's, on the CPU.

The panels are those of tests/test_distributed.py (2 loci) and
tests/test_distributed_scale.py (16 loci), written with the port's copies
of the reference's writers.  Two real OS processes each genotype their
half with ``device="cpu"``; process 0 merges, and the merge must equal one
process's records and the reference's ``run_sharded_panel`` run in this
process.  The worker script guards its body with
``if __name__ == "__main__":``: the model cache's build pool spawns, and
each spawned child imports the script again as ``__mp_main__``."""

import dataclasses
import json
import os
import random
import signal
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from advntr_tpu.config import Config as JConfig
from advntr_tpu.models.db import load_unique_vntrs_data as jload
from advntr_tpu.parallel import distributed as jdist
from advntr_tpu_torch.config import Config
from advntr_tpu_torch.engine.simulate import simulate_diploid_reads
from advntr_tpu_torch.io.bam import BamRead, BamWriter, build_bai
from advntr_tpu_torch.models.db import (create_vntrs_database,
                                        load_unique_vntrs_data,
                                        save_reference_vntr_to_database)
from advntr_tpu_torch.models.reference_vntr import ReferenceVNTR
from advntr_tpu_torch.parallel.distributed import (gather_results,
                                                   initialize,
                                                   run_sharded_panel,
                                                   shard_loci)

# the suite runs test files in parallel worker processes: one torch thread
# each keeps them from oversubscribing the cores
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
# one model-build worker a process: its spawn pool is what needs the guard
IO_THREADS = 2


def test_shard_loci_partition_equals_reference():
    ids = list(range(10))
    shards = [shard_loci(ids, p, 3) for p in range(3)]
    assert shards == [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9]]
    for n in (1, 2, 3, 7, 16, 17):
        for procs in (1, 2, 3, 4):
            ids = list(range(n))
            got = [shard_loci(ids, p, procs) for p in range(procs)]
            assert got == [jdist.shard_loci(ids, p, procs)
                           for p in range(procs)]
            assert [v for s in got for v in s] == ids


def test_gather_results(tmp_path):
    out = str(tmp_path / "shards")
    assert gather_results({"1": "2/3", "2": "4/4"}, 1, 2, out) is None
    merged = gather_results({"0": "1/5"}, 0, 2, out)
    assert merged == {"0": "1/5", "1": "2/3", "2": "4/4"}


def test_gather_results_missing_shard_is_fatal(tmp_path):
    out = str(tmp_path / "shards")
    with pytest.raises(RuntimeError, match="shard 1 missing"):
        gather_results({"0": "1/5"}, 0, 2, out, timeout_s=0.3)


# ---- the panels ------------------------------------------------------------

PATTERNS = {301645: "CGCGGGGCGGGG", 301646: "TTAGGGATTCGC"}
VNTR_STARTS = {301645: 5000, 301646: 20000}
ALLELES = {301645: (2, 5), 301646: (3, 3)}


def _rand_seq(seed, n):
    rng = random.Random(seed)
    return "".join(rng.choice("ACGT") for _ in range(n))


def write_two_locus_panel(tmp):
    """tests/test_distributed.py's panel: two loci, 100 bp reads at
    coverage 40, half of them mapped."""
    db = str(tmp / "models.db")
    create_vntrs_database(db)
    mapped, unmapped = [], []
    for i, (vid, pattern) in enumerate(sorted(PATTERNS.items())):
        left, right = _rand_seq(10 + i, 300), _rand_seq(20 + i, 300)
        ref = ReferenceVNTR(vid, pattern, VNTR_STARTS[vid], "chr21",
                            f"G{vid}", "Promoter", 3)
        ref.repeat_segments = [pattern] * 3
        ref.left_flanking_region = left
        ref.right_flanking_region = right
        save_reference_vntr_to_database(ref, db)
        reads, _, _ = simulate_diploid_reads(
            left, pattern, *ALLELES[vid], right, read_length=100,
            coverage=40, error_rate=0.002, seed=5 + i)
        for j, (name, seq) in enumerate(reads):
            name = f"{vid}_{name}"
            if j % 2 == 0:
                mapped.append(BamRead(
                    query_name=name, flag=0, reference_id=0,
                    reference_start=VNTR_STARTS[vid] - 50 + (j % 100),
                    mapq=60, cigar=[(0, len(seq))], seq=seq,
                    qual=[38] * len(seq)))
            else:
                unmapped.append(BamRead(
                    query_name=name, flag=4, reference_id=-1,
                    reference_start=-1, mapq=0, cigar=[], seq=seq,
                    qual=[38] * len(seq)))
    mapped.sort(key=lambda r: r.reference_start)
    bam = str(tmp / "panel.bam")
    with BamWriter(bam, ["chr21"], [100000]) as w:
        for r in mapped + unmapped:
            w.write(r)
    build_bai(bam)
    return db, bam


def write_scale_panel(tmp, n_loci):
    """tests/test_distributed_scale.py's panel: n_loci random 8-12 bp
    motifs, 100 bp unmapped reads at coverage 15."""
    rng = random.Random(9)
    db = str(tmp / "models.db")
    create_vntrs_database(db)
    bam = str(tmp / "panel.bam")
    with BamWriter(bam, ["chr1"], [100_000_000]) as w:
        for i in range(n_loci):
            plen = rng.choice([8, 10, 12])
            pattern = "".join(rng.choice("ACGT") for _ in range(plen))
            left = "".join(rng.choice("ACGT") for _ in range(150))
            right = "".join(rng.choice("ACGT") for _ in range(150))
            maxc = max(2, (100 - 40) // plen)
            refc = rng.randint(2, maxc)
            ref = ReferenceVNTR(1000 + i, pattern, 10_000 * (i + 1), "chr1")
            ref.repeat_segments = [pattern] * refc
            ref.left_flanking_region = left
            ref.right_flanking_region = right
            ref.estimated_repeats = refc
            save_reference_vntr_to_database(ref, db)
            a = tuple(sorted((rng.randint(2, maxc), rng.randint(2, maxc))))
            reads, _, _ = simulate_diploid_reads(
                left, pattern, a[0], a[1], right, read_length=100,
                coverage=15, error_rate=0.002, seed=100 + i)
            for name, seq in reads:
                w.write(BamRead(f"L{ref.id}_{name}", 4, -1, -1, 0, [],
                                seq, [38] * len(seq)))
    return db, bam


WORKER = textwrap.dedent("""
    import dataclasses, json, os, sys


    def main():
        import torch
        torch.set_num_threads(1)
        from advntr_tpu_torch.config import Config
        from advntr_tpu_torch.models.db import load_unique_vntrs_data
        from advntr_tpu_torch.parallel.distributed import run_sharded_panel

        db, bam, workdir, pid, nproc, io_threads = sys.argv[1:7]
        pid, nproc = int(pid), int(nproc)
        refs = load_unique_vntrs_data(db)
        ids = sorted(r.id for r in refs)
        config = dataclasses.replace(Config(), io_threads=int(io_threads))
        merged = run_sharded_panel(refs, ids, bam, workdir, config,
                                   process_id=pid, num_processes=nproc,
                                   device="cpu")
        if pid == 0:
            with open(os.path.join(workdir, "merged.json"), "w") as fh:
                json.dump(merged, fh)


    if __name__ == "__main__":
        main()
""")


def stop(procs):
    """Stop each process and the build pool it started: each leads a
    process group of its own."""
    for p in procs:
        try:
            os.killpg(p.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        p.wait()


def run_processes(db, bam, workdir, nproc, timeout=600):
    """Run the worker in ``nproc`` OS processes over one panel; returns
    process 0's merged records."""
    workdir.mkdir()
    script = workdir / "worker.py"
    script.write_text(WORKER)
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(script), db, bam, str(workdir), str(p),
         str(nproc), str(IO_THREADS)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        start_new_session=True)
        for p in range(nproc)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, err.decode()[-2000:]
    finally:
        stop(procs)
    with open(workdir / "merged.json") as fh:
        return json.load(fh)


@pytest.fixture(scope="module")
def two_locus(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_panel")
    db, bam = write_two_locus_panel(tmp)
    refs = jload(db)
    (tmp / "reference").mkdir()
    want = jdist.run_sharded_panel(
        refs, sorted(r.id for r in refs), bam, str(tmp / "reference"),
        dataclasses.replace(JConfig(), io_threads=IO_THREADS))
    return db, bam, want


def _genotypes(merged):
    return {vid: sorted(rec["copy_numbers"]) for vid, rec in merged.items()}


def test_run_sharded_panel_single_process(two_locus, tmp_path):
    db, bam, want = two_locus
    refs = load_unique_vntrs_data(db)
    merged = run_sharded_panel(
        refs, sorted(r.id for r in refs), bam, str(tmp_path),
        dataclasses.replace(Config(), io_threads=IO_THREADS),
        process_id=0, num_processes=1, device="cpu")
    assert merged == want
    assert _genotypes(merged) == {str(v): sorted(a)
                                  for v, a in ALLELES.items()}


def test_run_sharded_panel_two_processes(two_locus, tmp_path):
    """Two OS processes, one locus each; process 0 merges: equal to one
    process's records and to the reference's."""
    db, bam, want = two_locus
    two = run_processes(db, bam, tmp_path / "two", 2)
    one = run_processes(db, bam, tmp_path / "one", 1)
    assert two == one == want
    assert not [v for v in two.values() if v["error"]]


def test_16_locus_panel_two_processes(tmp_path):
    """tests/test_distributed_scale.py's 16-locus panel: two processes
    merge to exactly one process's structured records, no error row."""
    db, bam = write_scale_panel(tmp_path, 16)
    two = run_processes(db, bam, tmp_path / "two", 2)
    one = run_processes(db, bam, tmp_path / "one", 1)
    assert len(two) == 16
    assert two == one
    assert not [v for v in two.values() if v["error"]]


def test_initialize_is_a_no_op_for_one_process():
    import torch.distributed as dist
    for n in (None, 1):
        initialize("localhost:1", num_processes=n, process_id=0,
                   device="cpu")
    assert not dist.is_initialized()


GLOO = textwrap.dedent("""
    import sys


    def main():
        import torch
        import torch.distributed as dist
        from advntr_tpu_torch.parallel.distributed import initialize
        address, pid = sys.argv[1], int(sys.argv[2])
        initialize(address, num_processes=2, process_id=pid, device="cpu")
        x = torch.tensor([pid + 1])
        dist.all_reduce(x)
        print(dist.get_backend(), dist.get_world_size(), int(x))
        dist.destroy_process_group()


    if __name__ == "__main__":
        main()
""")


def test_initialize_brings_up_two_gloo_processes(tmp_path):
    """Two processes meet at a localhost address through ``initialize``
    and sum a tensor over the gloo group."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    script = tmp_path / "gloo.py"
    script.write_text(GLOO)
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(script), f"localhost:{port}", str(p)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        start_new_session=True)
        for p in range(2)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        stop(procs)
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err.decode()[-2000:]
        assert out.decode().split() == ["gloo", "2", "3"]
