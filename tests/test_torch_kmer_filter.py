"""The port's recruitment filter against the JAX filter: identical
recruited reads and counts on the dense path, the top-M path
(n_loci > 16), long-keyword host verification and the per-locus cap."""

import random

import pytest
import torch

from advntr_tpu.engine.recruitment import keywords_for_locus as jax_keywords
from advntr_tpu.models.reference_vntr import ReferenceVNTR
from advntr_tpu.ops.kmer_filter import RecruitmentFilter as JaxFilter
from advntr_tpu_torch.engine.recruitment import (build_recruitment_filter,
                                                 filter_reads,
                                                 keywords_for_locus)
from advntr_tpu_torch.ops.kmer_filter import RecruitmentFilter

# the suite runs test files in parallel worker processes: one torch thread
# each keeps them from oversubscribing the cores
torch.set_num_threads(1)

KEYWORDS = {1: ["ACCC", "CACC", "CCAC", "CCCA"],
            2: ["TGGT", "TTGG", "GTTG", "GGTT"]}
READS = [
    ("one", "ACCCNNNNNNNNNNNN"),
    ("two", "ACCCACCCNNNNNNNN"),
    ("three", "ACCCACCCNNNNCCCT"),
    ("four", "ACCCACCCACCCACCC"),
    ("one_ACCC_one_TTGG", "ACCCTTGGNNNNNNNN"),
]


def _both(keywords, reads, **kw):
    names = [n for n, _ in reads]
    seqs = [s for _, s in reads]
    out = []
    for cls, extra in ((JaxFilter, {}), (RecruitmentFilter,
                                         {"device": "cpu"})):
        filt = cls(keywords, **kw, **extra)
        filt.process_batch(names, seqs)
        out.append(filt.results())
    return out


@pytest.mark.parametrize("min_matches", [1, 4])
def test_readme_example_matches_reference(min_matches):
    ref, got = _both(KEYWORDS, READS, k=4, min_matches=min_matches)
    assert got == ref
    assert got[0][1]


def test_cap_per_locus_matches_reference():
    reads = [(f"r{i}", "ACGT" * (i + 1)) for i in range(10)]
    ref, got = _both({1: ["ACGT"]}, reads, k=4, min_matches=1,
                     max_reads_per_locus=3)
    assert got == ref
    assert [n for n, _ in got[0][1]] == ["r9", "r8", "r7"]


def test_long_keywords_verified_on_host():
    kw = "ACGTACGTACGTACGTACGT"
    reads = [("full", "GG" + kw + "GG"),
             ("prefix_only", "GG" + kw[:15] + "TTTTTGG")]
    ref, got = _both({7: [kw]}, reads, k=15, min_matches=1)
    assert got == ref
    assert [n for n, _ in got[0][7]] == ["full"]


def _planted_panel(n_loci, n_reads, seed):
    rng = random.Random(seed)
    keywords = {}
    for li in range(n_loci):
        kws = set()
        while len(kws) < 4:
            kws.add("".join(rng.choice("ACGT") for _ in range(15)))
        keywords[li] = kws
    reads = []
    for i in range(n_reads):
        s = "".join(rng.choice("ACGT") for _ in range(120))
        if i % 2 == 0:
            li = rng.randrange(n_loci)
            for j, kw in enumerate(sorted(keywords[li])):
                p = 10 + j * 20
                s = s[:p] + kw + s[p + 15:]
            kw = sorted(keywords[li])[0]
            s = s[:95] + kw + s[110:]
        reads.append((f"r{i}", s))
    return keywords, reads


@pytest.mark.parametrize("top_m", [16, 10_000])
def test_planted_panel_matches_reference(top_m):
    """24 loci: the top-M compaction path (top_m=16) and the dense path."""
    keywords, reads = _planted_panel(24, 40, seed=3)
    ref, got = _both(keywords, reads, k=15, min_matches=5, top_m=top_m)
    assert got == ref
    assert any(got[0].values())


def test_top_m_ties_keep_the_reference_order():
    """One read hits 20 loci at least min_matches times (> top_m of 16):
    which 16 are kept depends on the order of equal counts, and it must be
    the reference's (jax.lax.top_k keeps the lower index first)."""
    shared = ["ACGTACGTTGCAACG", "TTGACCAGTAGGCAT"]
    keywords = {li: shared + ["".join(random.Random(li).choice("ACGT")
                                      for _ in range(15))]
                for li in range(20)}
    read = ("hit_all", "GG".join(shared * 3) + "A" * 10)
    ref, got = _both(keywords, [read, ("miss", "C" * 60)], k=15,
                     min_matches=5)
    assert got == ref
    assert sum(1 for r in got[0].values()
               if "hit_all" in dict(r)) == 16


def test_chunked_batches_match_reference(monkeypatch):
    monkeypatch.setenv("ADVNTR_TPU_RECRUIT_CHUNK", "8")
    keywords, reads = _planted_panel(24, 40, seed=8)
    ref, got = _both(keywords, reads, k=15, min_matches=5)
    assert got == ref


@pytest.mark.parametrize("value", ["0", "-4", "12.5", "many"])
def test_recruit_chunk_refuses_a_bad_limit(monkeypatch, value):
    """ADVNTR_TPU_RECRUIT_CHUNK below 1 or not an integer: a ValueError
    that names the variable, where 0 failed deep in a range() and a
    negative value recruited nothing."""
    from advntr_tpu_torch.ops.kmer_filter import recruit_chunk
    monkeypatch.setenv("ADVNTR_TPU_RECRUIT_CHUNK", value)
    with pytest.raises(ValueError, match="ADVNTR_TPU_RECRUIT_CHUNK"):
        recruit_chunk(100)
    filt = build_recruitment_filter([_orchestration_ref()], [1],
                                    device="cpu")
    with pytest.raises(ValueError, match="ADVNTR_TPU_RECRUIT_CHUNK"):
        filter_reads(filt, iter([("r", "AC" * 60)]))


def test_recruit_chunk_takes_a_good_limit(monkeypatch):
    from advntr_tpu_torch.ops.kmer_filter import DEFAULT_CHUNK, recruit_chunk
    monkeypatch.setenv("ADVNTR_TPU_RECRUIT_CHUNK", "1")
    assert recruit_chunk(100) == 1
    monkeypatch.delenv("ADVNTR_TPU_RECRUIT_CHUNK")
    assert recruit_chunk(6719) == DEFAULT_CHUNK


def _orchestration_ref():
    ref = ReferenceVNTR(1, "CACAGT", 1000, "chr1")
    ref.repeat_segments = ["CACAGT"] * 3
    ref.left_flanking_region = "AC" * 60
    ref.right_flanking_region = "GT" * 60
    return ref


def test_keywords_and_filter_orchestration():
    ref = ReferenceVNTR(1, "CACAGT", 1000, "chr1")
    ref.repeat_segments = ["CACAGT"] * 3
    ref.left_flanking_region = "AC" * 60
    ref.right_flanking_region = "GT" * 60
    for short in (True, False):
        assert keywords_for_locus(ref, short, 15) == \
            jax_keywords(ref, short, 15)
    filt = build_recruitment_filter([ref], [1], device="cpu")
    read = "AC" * 20 + "CACAGT" * 3 + "GT" * 20
    results, seqs = filter_reads(filt, iter([("r", read), ("n", "A" * 80)]))
    assert [n for n, _ in results[1]] == ["r"] and seqs == {"r": read}
