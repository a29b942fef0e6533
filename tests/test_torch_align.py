"""The port's flank anchoring (ops/align.py) against the JAX reference:
``local_align_batch`` in plain PyTorch on the CPU gives the JAX scan's
(score, end) exactly (all arithmetic is int32), both agree with the numpy
``local_align`` on every read, and ``anchor_probes_batch`` returns the
reference's ``anchor_probe_batch`` (score, start, end) triples exactly."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advntr_tpu import dna as jdna
from advntr_tpu.ops import align as jalign
from advntr_tpu_torch import dna
from advntr_tpu_torch.ops import align

# the suite runs test files in parallel worker processes: one torch thread
# each keeps them from oversubscribing the cores
torch.set_num_threads(1)


def _reads(seed, n_reads, max_len, probe):
    """Random reads of ragged lengths (one of length 1, one of full
    length); most carry a copy of the probe with substitutions and a
    deleted or inserted base, some carry two copies (ties between rows),
    some none."""
    rng = random.Random(seed)
    reads = []
    for i in range(n_reads):
        n = [1, max_len][i] if i < 2 else rng.randint(len(probe), max_len)
        s = [rng.choice("ACGT") for _ in range(n)]
        for _ in range(rng.choice([0, 1, 1, 1, 2])):
            p = list(probe)
            for j in range(len(p)):
                if rng.random() < 0.06:
                    p[j] = rng.choice("ACGT")
            if rng.random() < 0.5:
                del p[rng.randrange(len(p))]
            else:
                p.insert(rng.randrange(len(p)), rng.choice("ACGT"))
            at = rng.randint(0, max(0, n - len(p)))
            s[at:at + len(p)] = p
        reads.append("".join(s[:n]))
    return reads


@pytest.mark.parametrize("seed,probe_len,max_len", [(1, 100, 400),
                                                    (2, 37, 250),
                                                    (3, 128, 300)])
def test_local_align_batch_equals_jax_and_numpy(seed, probe_len, max_len):
    rng = random.Random(100 + seed)
    probe = "".join(rng.choice("ACGT") for _ in range(probe_len))
    reads = _reads(seed, 14, max_len, probe)
    rows = [dna.encode(r) for r in reads]
    batch, lengths = dna.pad_batch(rows, multiple=32)
    pcodes = dna.encode(probe)
    score, end = align.local_align_batch(
        torch.as_tensor(batch), torch.as_tensor(lengths),
        torch.as_tensor(pcodes))
    assert score.dtype == end.dtype == torch.int32
    jscore, jend = jalign.local_align_batch(
        jnp.asarray(batch), jnp.asarray(lengths), jnp.asarray(pcodes))
    np.testing.assert_array_equal(score.numpy(), np.asarray(jscore))
    np.testing.assert_array_equal(end.numpy(), np.asarray(jend))
    for b, read in enumerate(reads):
        s, _, e = align.local_align(read, probe)
        assert (int(score[b]), int(end[b])) == (s, e), b


def test_anchor_probe_batch_equals_reference():
    rng = random.Random(7)
    probe = "".join(rng.choice("ACGT") for _ in range(100))
    reads = _reads(9, 10, 500, probe)
    reads += [jdna.revcomp(r) for r in reads[:4]]
    rows = [dna.encode(r) for r in reads]
    pcodes = dna.encode(probe)
    got, = align.anchor_probes_batch(rows, [pcodes], device="cpu")
    want = jalign.anchor_probe_batch([jdna.encode(r) for r in reads],
                                     jdna.encode(probe))
    assert got == want
    for read, (s, start, e) in zip(reads, got):
        s0, start0, e0 = align.local_align(read, probe)
        assert (s, e) == (s0, e0)
    assert align.anchor_probes_batch([], [pcodes], device="cpu") == [[]]


def test_rows_past_a_reads_length_change_nothing():
    """Padding columns and a longer neighbour leave a read's score and end
    as they were: the padded batch gives each read alone."""
    rng = random.Random(5)
    probe = "".join(rng.choice("ACGT") for _ in range(40))
    reads = _reads(11, 6, 200, probe)
    pcodes = torch.as_tensor(dna.encode(probe))
    rows = [dna.encode(r) for r in reads]
    batch, lengths = dna.pad_batch(rows, pad_to=320, multiple=32)
    score, end = align.local_align_batch_reference(
        torch.as_tensor(batch), torch.as_tensor(lengths), pcodes)
    for b, codes in enumerate(rows):
        s1, e1 = align.local_align_batch_reference(
            torch.as_tensor(codes[None]), torch.tensor([len(codes)]), pcodes)
        assert (int(score[b]), int(end[b])) == (int(s1[0]), int(e1[0]))


def test_cuda_tensor_goes_to_the_kernel(monkeypatch):
    """A CUDA tensor reaches the kernel wrapper and never the plain
    version; the wrapper refuses a probe a warp cannot hold."""
    from advntr_tpu_torch.ops import _kernels
    calls = []
    monkeypatch.setattr(
        _kernels, "local_align_passes",
        lambda *a: calls.append("kernel") or (torch.zeros(1, 1),) * 2)
    monkeypatch.setattr(align, "local_align_batch_reference",
                        lambda *a: calls.append("plain"))

    class FakeCuda:
        is_cuda = True
        shape = (1,)

        def to(self, dtype):
            return self

        def __getitem__(self, index):
            return self

    align.local_align_batch(FakeCuda(), torch.ones(1), FakeCuda())
    assert calls == ["kernel"]
    monkeypatch.undo()
    with pytest.raises(ValueError, match="probes of 1 to 128"):
        _kernels.local_align_passes(torch.zeros(1, 2, 8, dtype=torch.int8),
                                    torch.ones(2, dtype=torch.int32),
                                    torch.zeros(1, 129, dtype=torch.int8),
                                    [129], [0])


def test_global_align_score_equals_reference():
    rng = random.Random(3)
    for _ in range(10):
        a = "".join(rng.choice("ACGT") for _ in range(rng.randint(5, 40)))
        b = "".join(rng.choice("ACGT") for _ in range(rng.randint(5, 40)))
        assert align.global_align_score(a, b) == \
            jalign.global_align_score(a, b)


# ---- the kernel's scheme in plain PyTorch (csrc/local_align.cu) ------------

N_CODE = 4      # background of the planted reads: matches no probe base


def _scheme_reads(probe, L, chunks, seed):
    """Reads that probe the chunked wavefront: lengths L, 1 and 0; a read
    shorter than the 2m warm-up rows; a noisy copy of the probe across the
    first chunk border; exact copies in the first and the last chunk
    (equal maxima in different chunks); the probe's two halves at
    different rows, in both orders (equal maxima ending in different
    lanes); and random reads."""
    rng = np.random.default_rng(seed)
    m = len(probe)
    rows = -(-L // chunks)
    reads = rng.integers(0, 4, (10, L)).astype(np.int8)
    lengths = np.array([L, 1, 0, min(2 * m - 1, L), L, L, L, L,
                        rng.integers(m, L + 1), L], dtype=np.int32)
    noisy = probe.copy()
    flips = rng.random(m) < 0.1
    noisy[flips] = rng.integers(0, 4, flips.sum())
    at = max(0, min(rows - m // 2, L - m))
    reads[0, at:at + m] = noisy
    reads[3, :m // 2] = probe[m - m // 2:]
    reads[5:8] = N_CODE
    reads[5, 3:3 + m] = probe
    reads[5, L - m - 2:L - 2] = probe
    half = max(1, m // 2)
    for r, (x, y) in ((6, (probe[:half], probe[m - half:])),
                      (7, (probe[m - half:], probe[:half]))):
        reads[r, 5:5 + half] = x
        reads[r, L - half - 4:L - 4] = y
    return reads, lengths


@pytest.mark.parametrize("chunks", [1, 2, 5])
@pytest.mark.parametrize("probe_len", [1, 7, 100, 128])
def test_wavefront_scheme_equals_jax_scan(probe_len, chunks):
    """The kernel's scheme (wavefront over the probe, chunks with 2m
    warm-up rows, per-lane first maxima combined once, chunks combined by
    the larger best and then the earlier end) gives the JAX scan's
    (score, end) exactly."""
    rng = np.random.default_rng(probe_len)
    probe = rng.integers(0, 4, probe_len).astype(np.int8)
    L = 4 * max(probe_len, 16) + 32
    reads, lengths = _scheme_reads(probe, L, chunks, seed=probe_len + chunks)
    score, end = align.local_align_wavefront_reference(
        torch.as_tensor(reads), torch.as_tensor(lengths),
        torch.as_tensor(probe), chunks)
    jscore, jend = jalign.local_align_batch(
        jnp.asarray(reads), jnp.asarray(lengths), jnp.asarray(probe))
    np.testing.assert_array_equal(score.numpy(), np.asarray(jscore))
    np.testing.assert_array_equal(end.numpy(), np.asarray(jend))
    assert int(score[2]) == int(end[2]) == 0
    # the exact copies: the best is m, and it ends in the first chunk
    assert (int(score[5]), int(end[5])) == (probe_len, 3 + probe_len)


@pytest.mark.parametrize("passes,B,L,m,chunks", [
    (1, 64, 3008, 100, 15), (1, 16, 12288, 100, 61), (4, 16, 12288, 100, 33),
    (4, 64, 3008, 100, 9), (4, 10, 3000, 100, 15), (1, 1, 100, 100, 1)])
def test_align_chunks_fill_the_card_and_keep_the_warm_up(passes, B, L, m,
                                                        chunks):
    """On 132 SMs: enough chunks for ALIGN_WARPS_PER_SM warps on each, but
    none shorter than its 2m warm-up rows, and at least one."""
    from advntr_tpu_torch.ops import _kernels
    assert _kernels.align_chunks(passes, B, L, m, 132) == chunks
    rows = -(-L // chunks)
    assert chunks == 1 or rows >= 2 * m


def test_anchor_probes_batch_is_each_probe_alone():
    """Two probes of different lengths in one call give each probe alone,
    which equals the reference's anchor_probe_batch."""
    rng = random.Random(17)
    left = "".join(rng.choice("ACGT") for _ in range(100))
    right = "".join(rng.choice("ACGT") for _ in range(61))
    reads = _reads(21, 8, 600, left) + _reads(22, 4, 600, right)
    rows = [dna.encode(r) for r in reads]
    got = align.anchor_probes_batch(
        rows, [dna.encode(left), dna.encode(right)], device="cpu")
    for probe, res in zip((left, right), got):
        assert [res] == align.anchor_probes_batch(
            rows, [dna.encode(probe)], device="cpu")
        assert res == jalign.anchor_probe_batch(
            [jdna.encode(r) for r in reads], jdna.encode(probe))
    assert align.anchor_probes_batch([], [dna.encode(left)], "cpu") == [[]]
