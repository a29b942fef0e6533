"""The port's per-locus engine (VNTRFinder on ``cpu``) against the
reference's VNTRFinder on the same candidate reads of the CSTB 2/5 locus:
scored reads, the genotype call, and the grouped path's vectorized gates
against the per-read gates."""

import dataclasses

import pytest
import torch

from advntr_tpu.engine.finder import LocusModelCache as JaxCache
from advntr_tpu.engine.finder import VNTRFinder as JaxFinder
from advntr_tpu.engine.simulate import simulate_diploid_reads
from advntr_tpu.models.reference_vntr import ReferenceVNTR
from advntr_tpu_torch.engine.finder import VNTRFinder
from advntr_tpu_torch.engine.locus_model import LocusModelCache
from advntr_tpu_torch.synthetic import CSTB_PATTERN, rand_seq

# the suite runs test files in parallel worker processes: one torch thread
# each keeps them from oversubscribing the cores
torch.set_num_threads(1)

READ_LEN = 100


def _jax_finder(ref):
    """The reference's finder with a model cache of its own: its default
    cache is process-wide and keyed by the locus ID, and the reference's
    tests build other models of this ID in the same worker process."""
    return JaxFinder(ref, model_cache=JaxCache())


@pytest.fixture(scope="module")
def locus():
    ref = ReferenceVNTR(301645, CSTB_PATTERN, 5000, "chr21", "CSTB",
                        "Promoter", 3)
    ref.repeat_segments = [CSTB_PATTERN] * 3
    ref.left_flanking_region = rand_seq(1, 300)
    ref.right_flanking_region = rand_seq(2, 300)
    reads, _, _ = simulate_diploid_reads(
        ref.left_flanking_region, CSTB_PATTERN, 2, 5,
        ref.right_flanking_region, read_length=READ_LEN, coverage=20,
        error_rate=0.002, seed=5)
    finder = VNTRFinder(ref, model_cache=LocusModelCache(device="cpu"))
    return ref, finder, reads[0::2], reads[1::2]


def test_scored_reads_match_reference(locus):
    ref, finder, mapped, unmapped = locus
    want, _ = _jax_finder(ref).score_reads(mapped, unmapped, READ_LEN)
    got, _ = finder.score_reads(mapped, unmapped, READ_LEN)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for field in ("sequence", "repeats", "repeat_bp", "left_flank_bp",
                      "right_flank_bp", "flank_rate", "n_matches",
                      "is_mapped", "query_name", "row"):
            assert getattr(g, field) == getattr(w, field), field
        # the reference scores with its structured kernel on the CPU, which
        # sums in another order (the contract of test_pallas_viterbi.py)
        assert g.logp == pytest.approx(w.logp, rel=1e-4, abs=1e-2)


@pytest.mark.parametrize("accuracy_filter", [False, True])
def test_find_repeat_count_matches_reference(locus, accuracy_filter):
    ref, finder, mapped, unmapped = locus
    want = _jax_finder(ref).find_repeat_count(mapped, unmapped, READ_LEN,
                                            accuracy_filter)
    got = finder.find_repeat_count(mapped, unmapped, READ_LEN,
                                   accuracy_filter)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert sorted(got.copy_numbers) == [2, 5]


@pytest.mark.parametrize("accuracy_filter", [False, True])
def test_grouped_gates_equal_per_read_gates(locus, accuracy_filter):
    """counts_from_stats (the grouped path) gives the same call as the
    ScoredRead path of find_repeat_count."""
    ref, finder, mapped, unmapped = locus
    reads, rows, row_info = finder.prepare_rows(mapped, unmapped)
    batch, lengths = finder.pad_rows(rows)
    stats = finder.run_device(finder.get_model(READ_LEN), batch, lengths)
    covered, flanking, n_sel, _ = finder.counts_from_stats(
        reads, row_info, stats, READ_LEN, accuracy_filter)
    grouped = finder.genotype_from_counts(covered, flanking, n_sel,
                                          accuracy_filter)
    per_read = finder.find_repeat_count(mapped, unmapped, READ_LEN,
                                        accuracy_filter)
    assert dataclasses.asdict(grouped) == dataclasses.asdict(per_read)


def test_struct_kernel_scored_reads_equal_reference(locus, monkeypatch):
    """``ADVNTR_TPU_KERNEL=struct``: the port's structured decoder scores
    every read as the reference's struct kernel does, logp bit for bit;
    the cache keeps one model a kernel (the kernel is in its key)."""
    ref, finder, mapped, unmapped = locus
    want, _ = _jax_finder(ref).score_reads(mapped, unmapped, READ_LEN)
    pallas = finder.get_model(READ_LEN)
    monkeypatch.setenv("ADVNTR_TPU_KERNEL", "struct")
    struct = finder.get_model(READ_LEN)
    assert struct is not pallas and struct.kernel == "struct"
    assert finder.get_model(READ_LEN) is struct
    got, _ = finder.score_reads(mapped, unmapped, READ_LEN)
    assert struct.struct is not None
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for f in dataclasses.fields(g):
            assert getattr(g, f.name) == getattr(w, f.name), f.name


@pytest.mark.parametrize("value", ["xla", "Pallas", "dense"])
def test_unknown_kernel_raises(locus, monkeypatch, value):
    _, finder, _, _ = locus
    monkeypatch.setenv("ADVNTR_TPU_KERNEL", value)
    with pytest.raises(ValueError, match=repr(value)):
        finder.get_model(READ_LEN)
