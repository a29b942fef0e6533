"""The port's ``addmodel`` training (engine/training.py) against the JAX
package: the logistic threshold equal to sklearn's on 300 seeded pairs of
score lists (the port fits it with scipy), the decoy scan equal, and
``train_and_add_model(device="cpu")`` on test_training_end_to_end.py's
chromosome writing the reference's database row, with which the locus
genotypes (4, 6)."""

import random
import warnings

import numpy as np
import pytest
import torch

from advntr_tpu.engine import training as jtraining
from advntr_tpu.io.fasta import write_fasta
from advntr_tpu.models.db import load_unique_vntrs_data as jload
from advntr_tpu_torch.config import Config
from advntr_tpu_torch.engine import training
from advntr_tpu_torch.engine.finder import VNTRFinder
from advntr_tpu_torch.engine.simulate import simulate_diploid_reads
from advntr_tpu_torch.models.db import load_unique_vntrs_data

# the suite runs test files in parallel worker processes: one torch thread
# each keeps them from oversubscribing the cores
torch.set_num_threads(1)


def score_lists(seed):
    """A seeded pair of score lists: 5-299 true scores around -20 to -60,
    0-300 decoy scores around -80 to -140, overlapping at times."""
    rng = np.random.default_rng(seed)
    n_true, n_false = int(rng.integers(5, 300)), int(rng.integers(0, 301))
    true = rng.normal(rng.uniform(-60, -20), rng.uniform(3, 15), n_true)
    false = rng.normal(rng.uniform(-140, -80), rng.uniform(5, 25), n_false)
    return [float(v) for v in true], [float(v) for v in false]


def test_threshold_equals_sklearn_on_300_pairs():
    threadpoolctl = pytest.importorskip("threadpoolctl")
    differ = []
    # one thread for sklearn's solver: the suite runs files in parallel
    with threadpoolctl.threadpool_limits(1), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for seed in range(300):
            true, false = score_lists(seed)
            want = jtraining.find_recruitment_score_threshold(true, false)
            got = training.find_recruitment_score_threshold(true, false)
            if got != want:
                differ.append((seed, got, want))
    assert differ == []


def test_threshold_edges_equal_sklearn():
    """No decoys (the reference's stand-in decoy at min - 2), one of each,
    and separated classes whose boundary lies past -299 (the largest true
    score is kept)."""
    cases = [([-30.0, -25.0, -41.5], []), ([-20.0], [-90.0]),
             ([-400.0, -380.0], [-900.0, -950.0]),
             ([-10.0, -12.0, -11.0], [-15.0, -13.0, -9.0])]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for true, false in cases:
            assert training.find_recruitment_score_threshold(true, false) \
                == jtraining.find_recruitment_score_threshold(true, false)


def _rand_seq(seed, n):
    rng = random.Random(seed)
    return "".join(rng.choice("ACGT") for _ in range(n))


PATTERN = "GATTCGAGGCTT"  # 12bp
COPIES = 4
VNTR_START = 8000


def _chromosome(planted: bool) -> str:
    """test_training_end_to_end.py's chromosome; under ``planted`` with
    two mutated copies of the repeat array put away from the locus, so
    that the decoy scan finds windows to score."""
    seq = list(_rand_seq(11, VNTR_START) + PATTERN * COPIES
               + _rand_seq(12, 8000))
    rng = random.Random(5)
    for at in ((2000, 13000) if planted else ()):
        frag = list(PATTERN * 3)
        for _ in range(2):
            frag[rng.randrange(len(frag))] = rng.choice("ACGT")
        seq[at:at + len(frag)] = frag
    return "".join(seq)


@pytest.fixture(scope="module")
def chromosome():
    return _chromosome(planted=True)


def test_decoy_scan_equals_reference(chromosome):
    from advntr_tpu.models.reference_vntr import ReferenceVNTR as JRef
    from advntr_tpu_torch.models.reference_vntr import ReferenceVNTR
    end = VNTR_START + len(PATTERN) * COPIES
    reads = []
    for cls, mod in ((ReferenceVNTR, training), (JRef, jtraining)):
        ref = cls(1, PATTERN, VNTR_START, "chrT", None, None,
                  int((end - VNTR_START) / len(PATTERN) + 5), chromosome)
        ref.init_from_vntrseek_data()
        reads.append(mod.simulate_false_filtered_reads(ref, chromosome,
                                                       read_size=150))
    assert reads[0] == reads[1] and len(reads[0]) > 0
    codes = np.array([0, 1, 2, 3, 4, 1, 2, 3, 0, 0, 1], dtype=np.int8)
    np.testing.assert_array_equal(training.rolling_kmer_codes(codes, 3),
                                  jtraining.rolling_kmer_codes(codes, 3))


@pytest.mark.parametrize("planted", [False, True])
def test_train_and_add_model_row_equals_reference(tmp_path, planted):
    """The reference's addmodel and the port's (``device="cpu"``) on the
    same chromosome write the same row: id, segments, flanks and
    scaled_score; the port's row genotypes simulated 4/6 reads as
    (4, 6)."""
    chromosome = _chromosome(planted)
    ref_fa = str(tmp_path / "ref.fa")
    write_fasta(ref_fa, [("chrT", chromosome)])
    kw = dict(reference_file=ref_fa, chromosome="chrT", pattern=PATTERN,
              start=VNTR_START, end=VNTR_START + len(PATTERN) * COPIES,
              gene="TESTG", annotation="Coding")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jtraining.train_and_add_model(db_file=str(tmp_path / "jax.db"),
                                      **kw)
    vid = training.train_and_add_model(db_file=str(tmp_path / "own.db"),
                                       device="cpu", **kw)
    assert vid == 1
    (want,), (got,) = jload(str(tmp_path / "jax.db")), \
        load_unique_vntrs_data(str(tmp_path / "own.db"))
    for field in ("id", "pattern", "start_point", "chromosome", "gene_name",
                  "annotation", "left_flanking_region",
                  "right_flanking_region", "scaled_score"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.get_repeat_segments() == want.get_repeat_segments() \
        == [PATTERN] * COPIES
    assert got.scaled_score != 0

    finder = VNTRFinder(got, Config(), device="cpu")
    reads, _, _ = simulate_diploid_reads(
        got.left_flanking_region, PATTERN, 4, 6, got.right_flanking_region,
        read_length=100, coverage=35, error_rate=0.003, seed=13)
    result = finder.find_repeat_count([], reads, read_length=100)
    assert tuple(sorted(result.copy_numbers)) == (4, 6)
