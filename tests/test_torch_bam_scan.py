"""The bulk scan of a BAM's unmapped records (``io/bam_scan.py``) against
``BamReader.fetch_unmapped``, and recruitment through it against the
per-record path: the same names, sequences and order; the same batches
uploaded and the same reads recruited, on the top-M, dense, long-keyword
and long-read paths; bounded chunks; the scan's counters; the per-record
path where the native walk cannot be built; and no new span under
``advntr.recruit``."""

import dataclasses
import random

import numpy as np
import pytest
import torch

from advntr_tpu_torch import native_bridge
from advntr_tpu_torch.config import DEFAULT_CONFIG
from advntr_tpu_torch.engine import analyzer as analyzer_mod
from advntr_tpu_torch.engine.analyzer import GenomeAnalyzer
from advntr_tpu_torch.engine.recruitment import filter_reads
from advntr_tpu_torch.io import bam_scan
from advntr_tpu_torch.io.bam import BamRead, BamReader, BamWriter
from advntr_tpu_torch.io.bgzf import BgzfWriter
from advntr_tpu_torch.models.db import load_unique_vntrs_data
from advntr_tpu_torch.ops.kmer_filter import RecruitmentFilter
from advntr_tpu_torch.synthetic import write_panel
from advntr_tpu_torch.utils import profiler
from portbench.generate import write_bam

# the suite runs test files in parallel worker processes: one torch thread
# each keeps them from oversubscribing the cores
torch.set_num_threads(1)

LETTERS = "=ACMGRSVTWYHKDBN"
# flags of aligned records (8: the mate unmapped, 256 secondary) and of
# unmapped ones (bit 4, with or without a mate)
ALIGNED_FLAGS = (0, 16, 1 | 8, 256)
UNMAPPED_FLAGS = (4, 4 | 1 | 8, 4 | 16, 4 | 1 | 64)


def _hand_records(seed: int, n: int) -> list:
    """Aligned records with CIGARs, unmapped ones placed at a mate's
    position among them, then unplaced unmapped ones; reads of odd and even
    lengths, of length 0, and of all 16 letters."""
    rng = random.Random(seed)
    placed, unplaced = [], []
    for i in range(n):
        length = rng.choice([0, 1, 2, 7, 15, 150, 151, 301])
        alphabet = LETTERS if i % 3 == 0 else "ACGT"
        seq = "".join(rng.choice(alphabet) for _ in range(length))
        qual = [rng.randrange(2, 41) for _ in range(length)]
        kind = i % 5
        if kind < 2:
            cigar = [(4, 1), (0, length - 2), (1, 1)] if length > 2 else \
                [(0, length)] if length else []
            placed.append(BamRead(f"m{i}", rng.choice(ALIGNED_FLAGS), 0,
                                  100 + 7 * i, 60, cigar, seq, qual))
        elif kind == 2:
            placed.append(BamRead(f"p{i}:x" * (1 + i % 4),
                                  rng.choice(UNMAPPED_FLAGS), 0, 100 + 7 * i,
                                  0, [], seq, qual))
        else:
            unplaced.append(BamRead(f"u{i}", rng.choice(UNMAPPED_FLAGS), -1,
                                    -1, 0, [], seq, qual))
    placed.sort(key=lambda r: r.reference_start)
    return placed + unplaced


def _write_hand(path: str, records: list) -> None:
    with BamWriter(path, ["chr1", "chr2"], [1_000_000, 5_000]) as w:
        for r in records:
            w.write(r)


def _bam(tmp_path, case: str) -> str:
    path = str(tmp_path / f"{case}.bam")
    if case == "hand":
        _write_hand(path, _hand_records(7, 900))
    elif case == "no_unmapped":
        _write_hand(path, [r for r in _hand_records(8, 300)
                           if not r.is_unmapped])
    elif case == "generated":
        rng = random.Random(9)
        reads = [(f"g{i}", "".join(rng.choice("ACGT") for _ in range(
            rng.choice([149, 150, 151])))) for i in range(1500)]
        placed = {reads[i][0]: 1000 + 40 * i for i in range(0, 1500, 3)}
        write_bam(path, reads, placed)
    return path


def _flatten(batches) -> list:
    return [(b.name(i), b.seq(i)) for b in batches for i in range(len(b))]


@pytest.mark.parametrize("case", ["hand", "generated", "no_unmapped"])
@pytest.mark.parametrize("chunk_bytes,batch_size", [
    (40, 7), (1000, 1024), (65536, 100), (bam_scan.CHUNK_BYTES, 1024)])
def test_scan_equals_fetch_unmapped(tmp_path, case, chunk_bytes,
                                    batch_size):
    path = _bam(tmp_path, case)
    with BamReader(path) as bam:
        want = [(r.query_name, r.seq) for r in bam.fetch_unmapped()]
    with BamReader(path) as bam:
        batches = list(bam_scan.scan_unmapped(bam, batch_size, chunk_bytes))
    assert _flatten(batches) == want
    assert (case == "no_unmapped") == (not want)
    assert [len(b) for b in batches[:-1]] == [batch_size] * \
        (len(batches) - 1)
    if case == "hand":
        # records split across BGZF blocks; every letter, odd lengths and
        # length 0 among the unmapped reads
        with BamReader(path) as bam:
            assert len(bam._bgzf.read(1 << 30)) > 2 * 65280
        assert set("".join(s for _, s in want)) == set(LETTERS)
        assert any(s == "" for _, s in want)
        assert any(len(s) % 2 for _, s in want)


@pytest.mark.parametrize("chunk_bytes", [1, 5000, 70000])
def test_inflated_chunks_are_bounded(tmp_path, chunk_bytes):
    """The inflater's chunks, laid end to end, are the reader's stream from
    the first record on, and none holds more than ``chunk_bytes`` and one
    block: memory stays bounded however large the file."""
    path = _bam(tmp_path, "hand")
    with BamReader(path) as bam:
        bam._bgzf.seek_virtual(bam._data_voffset)
        stream = bam._bgzf.read(1 << 30)
        pieces = list(bam_scan._inflated(path, bam._data_voffset,
                                         chunk_bytes))
    assert b"".join(pieces) == stream
    assert len(pieces) >= len(stream) // (chunk_bytes + 65536)
    assert max(map(len, pieces)) < chunk_bytes + 65536


def test_scan_counts_and_rejects_a_truncated_file(tmp_path):
    path = _bam(tmp_path, "hand")
    with BamReader(path) as bam:
        n_records = sum(1 for _ in bam)
        n_unmapped = sum(1 for _ in bam.fetch_unmapped())
    with profiler.span(profiler.CALL):
        with BamReader(path) as bam:
            list(bam_scan.scan_unmapped(bam, 64, 5000))
    counters = profiler.finished_calls()[-1].counters
    assert counters["recruit.scan_records"] == n_records
    assert counters["recruit.scan_unmapped"] == n_unmapped
    # a file cut inside its last record
    with BamReader(path) as bam:
        bam._bgzf.seek_virtual(0)
        stream = bam._bgzf.read(1 << 30)
    cut = str(tmp_path / "cut.bam")
    with BgzfWriter(cut) as w:
        w.write(stream[:-10])
    with BamReader(cut) as bam, pytest.raises(ValueError, match="truncated"):
        list(bam_scan.scan_unmapped(bam))


def test_codes_equal_the_per_read_batch():
    """``PackedReads.codes`` against ``dna.encode`` and ``pad_batch`` of the
    reads' letters, as ``_process_chunk`` lays them: every code, odd
    lengths, rows of length 0, a row count that is not a power of two."""
    rng = random.Random(3)
    seqs = ["".join(rng.choice(LETTERS) for _ in range(n))
            for n in [0, 1, 5, 150, 151, 0, 129, 300, 2, 77, 255]]
    packed = [_pack(s) for s in seqs]
    reads = bam_scan.PackedReads(
        np.frombuffer(b"".join(f"r{i}".encode() for i in range(len(seqs))),
                      dtype=np.uint8),
        np.cumsum([0] + [len(f"r{i}") for i in range(len(seqs))]),
        np.frombuffer(b"".join(packed), dtype=np.uint8),
        np.cumsum([0] + [len(p) for p in packed]),
        np.array([len(s) for s in seqs], dtype=np.int32))
    got = _captured(lambda f: f.process_packed(reads))
    want = _captured(lambda f: f.process_batch(
        [f"r{i}" for i in range(len(seqs))], seqs))
    _same_batches(got, want)
    assert [reads.seq(i) for i in range(len(seqs))] == seqs
    assert got[0][0].shape == (16, 384)


def _pack(seq: str) -> bytes:
    codes = [LETTERS.index(c) for c in seq] + [0]
    return bytes(codes[i] << 4 | codes[i + 1] for i in range(0, len(seq), 2))


def _captured(run) -> list:
    """(batch, lengths, reads) of every chunk a filter enqueues."""
    chunks = []
    filt = RecruitmentFilter({1: ["ACGTACGTACGTACG"]}, device="cpu")
    enqueue = filt._enqueue

    def spy(batch, lengths, n, name_of, seq_of):
        chunks.append((batch.copy(), lengths.copy(), n))
        return enqueue(batch, lengths, n, name_of, seq_of)
    filt._enqueue = spy
    run(filt)
    return chunks


def _same_batches(got, want):
    assert len(got) == len(want)
    for (b1, l1, n1), (b2, l2, n2) in zip(got, want):
        assert n1 == n2
        assert b1.dtype == b2.dtype and l1.dtype == l2.dtype
        np.testing.assert_array_equal(b1, b2)
        np.testing.assert_array_equal(l1, l2)


# ---- recruitment through the scan ----------------------------------------

@pytest.fixture(scope="module")
def panel(tmp_path_factory):
    """A 20-locus panel's reads in a BAM: a third aligned, the rest
    unmapped, some of them placed among the aligned; odd read lengths;
    decoys of the 16 letters; and the same records as SAM."""
    tmp = tmp_path_factory.mktemp("scan_panel")
    db, panel_bam, _ = write_panel(str(tmp), n_loci=20, read_length=151,
                                   coverage=12, seed=5)
    with BamReader(panel_bam) as bam:
        reads = [(r.query_name, r.seq) for r in bam]
    rng = random.Random(11)
    reads += [(f"decoy{i}", "".join(rng.choice(LETTERS) for _ in range(
        rng.choice([0, 99, 150])))) for i in range(300)]
    rng.shuffle(reads)
    placed, unplaced = [], []
    for i, (name, seq) in enumerate(reads):
        q = [30] * len(seq)
        if i % 3 == 0:
            placed.append(BamRead(name, 0, 0, 10 * i, 60,
                                  [(0, len(seq))] if seq else [], seq, q))
        elif i % 3 == 1:
            placed.append(BamRead(name, 4 | 1, 0, 10 * i, 0, [], seq, q))
        else:
            unplaced.append(BamRead(name, 4, -1, -1, 0, [], seq, q))
    placed.sort(key=lambda r: r.reference_start)
    path = str(tmp / "mixed.bam")
    with BamWriter(path, ["chr1"], [1_000_000]) as w:
        for r in placed + unplaced:
            w.write(r)
    sam = str(tmp / "mixed.sam")
    with open(sam, "w") as fh:
        fh.write("@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:chr1\tLN:1000000\n")
        for r in placed + unplaced:
            fh.write("\t".join([
                r.query_name, str(r.flag),
                "chr1" if r.reference_id >= 0 else "*",
                str(r.reference_start + 1), str(r.mapq),
                "".join(f"{n}M" for _, n in r.cigar) or "*", "*", "0", "0",
                r.seq or "*", "".join(chr(q + 33) for q in r.qual) or "*"])
                + "\n")
    return load_unique_vntrs_data(db), path, sam


def _old_path(filt, reader, batch_size=1024):
    return filter_reads(filt, ((r.query_name, r.seq)
                               for r in reader.fetch_unmapped()), batch_size)


def _recruit(panel_data, n_loci, illumina, keyword_size, path, old=False):
    """``recruit_unmapped_reads`` in a call of its own (on the per-record
    path where ``old``): its dict, the chunks its filter enqueued, and the
    call's totals."""
    vntrs, _, _ = panel_data
    ids = [v.id for v in vntrs][:n_loci]
    config = dataclasses.replace(DEFAULT_CONFIG, io_threads=1,
                                 keyword_size=keyword_size)
    analyzer = GenomeAnalyzer(vntrs, ids, working_dir="", config=config,
                              device="cpu")
    chunks = []
    enqueue = RecruitmentFilter._enqueue

    def spy(self, batch, lengths, n, name_of, seq_of):
        chunks.append((batch.copy(), lengths.copy(), n))
        return enqueue(self, batch, lengths, n, name_of, seq_of)
    with pytest.MonkeyPatch.context() as m:
        m.setattr(RecruitmentFilter, "_enqueue", spy)
        if old:
            m.setattr(analyzer_mod, "filter_unmapped", _old_path)
        with profiler.span(profiler.CALL):
            got = analyzer.recruit_unmapped_reads(path, illumina=illumina)
    return got, chunks, profiler.finished_calls()[-1]


@pytest.mark.parametrize("n_loci,illumina,keyword_size,chunk", [
    (20, True, 15, None),      # top-M on the device
    (4, True, 15, None),       # every count to the host
    (20, True, 21, None),      # long keywords recounted on the host
    (20, False, 15, None),     # long-read flank probes
    (20, True, 15, "300"),     # chunks of 300 inside the batches of 1,024
])
def test_recruit_bam_equals_the_per_record_path(panel, monkeypatch, n_loci,
                                                illumina, keyword_size,
                                                chunk):
    if chunk:
        monkeypatch.setenv("ADVNTR_TPU_RECRUIT_CHUNK", chunk)
    _, bam, _ = panel
    new, new_chunks, new_call = _recruit(panel, n_loci, illumina,
                                         keyword_size, bam)
    old, old_chunks, old_call = _recruit(panel, n_loci, illumina,
                                         keyword_size, bam, old=True)
    assert new == old
    assert sum(len(v) for v in new.values()) > 20
    _same_batches(new_chunks, old_chunks)
    assert new_chunks[-1][2] < (int(chunk) if chunk else 1024)
    c = new_call.counters
    assert c["recruit.scan_unmapped"] == c["recruit.reads"] == \
        old_call.counters["recruit.reads"]
    with BamReader(bam) as reader:
        assert c["recruit.scan_records"] == sum(1 for _ in reader)
    assert "recruit.scan_records" not in old_call.counters
    assert c["recruit.hits"] == old_call.counters["recruit.hits"]


def test_sam_keeps_the_per_record_path_and_no_span_is_added(panel):
    """A SAM input recruits what its BAM does, with no scan counters; and
    the BAM call's spans are the names, and the parents, of the per-record
    path's: the scan runs in ``advntr.recruit``'s own time."""
    _, bam, sam = panel
    profiler.enable(records=True)
    try:
        from_bam, _, bam_call = _recruit(panel, 20, True, 15, bam)
        bam_records = profiler.records()
        profiler.enable(records=True)
        from_sam, _, sam_call = _recruit(panel, 20, True, 15, sam)
        sam_records = profiler.records()
    finally:
        profiler.disable()
    assert from_bam == from_sam
    assert "recruit.scan_records" not in sam_call.counters
    assert "recruit.scan_unmapped" not in sam_call.counters
    assert set(bam_call.spans) == set(sam_call.spans) == {
        profiler.CALL, "advntr.recruit", "advntr.recruit.filter",
        "advntr.recruit.drain"}

    def tree(records):
        by_id = {r.id: r.name for r in records}
        return {(r.name, by_id.get(r.parent)) for r in records}
    assert tree(bam_records) == tree(sam_records)


def test_no_native_walk_parses_record_by_record(panel, monkeypatch):
    """Where the scan's C walk cannot be built, a BAM's unmapped reads are
    parsed one at a time: the same reads recruited, no scan counters."""
    _, bam, _ = panel
    scanned, _, _ = _recruit(panel, 20, True, 15, bam)

    def no_toolchain():
        raise FileNotFoundError("g++")
    monkeypatch.setattr(native_bridge, "load_bam_scan", no_toolchain)
    parsed, _, call = _recruit(panel, 20, True, 15, bam)
    assert parsed == scanned
    assert "recruit.scan_records" not in call.counters
    assert call.counters["recruit.reads"] > 0
