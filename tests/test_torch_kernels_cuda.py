"""The port's CUDA kernels (B1 forward, B2 backward walk) against their
plain PyTorch twins on the card, at small sizes, per locus and as groups
of same-shape loci in one launch.

Needs a CUDA device and nvcc; skips elsewhere.  On the GPU host (no jax
there) run it without the suite's jax conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import random

import numpy as np
import pytest
import torch

from advntr_tpu_torch import dna
from advntr_tpu_torch.ops import _kernels
from advntr_tpu_torch.ops import viterbi_fused as vf
from advntr_tpu_torch.ops.struct_model import TorchStructModel
from advntr_tpu_torch.synthetic import locus_model, rand_seq

pytestmark = pytest.mark.cuda

CASES = [
    (["CAGCAG", "CAGCAG", "CAACAG"], "ACGTTGCA", "TTACGGAT", 3),
    (["CGCGGGGCGGGG"] * 3, rand_seq(3, 40), rand_seq(4, 40), 5),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _batch(case, n_reads, seed, min_len=1):
    units, left, right, copies = case
    rng = random.Random(seed)
    reads = []
    for _ in range(n_reads):
        hap = left + units[0] * rng.randint(1, copies + 1) + right
        a = rng.randint(0, len(hap) - 1)
        n = rng.randint(min_len, len(hap) - a)
        reads.append(hap[a:a + n])
    rows = [dna.encode(r) for r in reads]
    batch, lengths = dna.pad_batch(rows, multiple=8)
    return torch.as_tensor(batch), torch.as_tensor(lengths)


@pytest.mark.parametrize("origin32", [False, True])
@pytest.mark.parametrize("n_reads", [5, 64])
@pytest.mark.parametrize("case", CASES)
def test_forward_kernel_matches_twin(cuda, case, n_reads, origin32):
    art, sm = locus_model(*case)
    m = TorchStructModel.from_payload(art, sm, cuda)
    seqs, lengths = _batch(case, n_reads, seed=n_reads)
    seqs, lengths = seqs.to(cuda), lengths.to(cuda)
    n0 = _kernels.LAUNCHES["forward"]
    got = vf.fused_forward(m, seqs, lengths, origin32)
    want = vf.fused_forward_reference(m, seqs, lengths, origin32)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["forward"] == n0 + 1
    for g, w, name in zip(got, want, ("best", "bstate", "oMI", "oXH")):
        assert g.dtype == w.dtype, name
        assert torch.equal(g, w), name


@pytest.mark.parametrize("case", CASES)
def test_backward_kernel_matches_twin(cuda, case):
    art, sm = locus_model(*case)
    m = TorchStructModel.from_payload(art, sm, cuda)
    seqs, lengths = _batch(case, 40, seed=7)
    lengths[:3] = 1                      # length-1 rows
    seqs, lengths = seqs.to(cuda), lengths.to(cuda)
    best, bstate, oMI, oXH = vf.fused_forward_reference(m, seqs, lengths)
    n0 = _kernels.LAUNCHES["backward"]
    path, stats = vf.backward_stats(m, lengths, bstate, oMI, oXH)
    path_w, stats_w = vf.backward_stats_reference(m, lengths, bstate, oMI,
                                                  oXH)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["backward"] == n0 + 1
    assert torch.equal(path, path_w)
    assert torch.equal(stats, stats_w)


def _assert_walk_equals_twin(m, planes, return_path):
    """The kernel, and the window scheme in plain PyTorch, against the
    column-by-column twin on the same planes."""
    path_w, stats_w = vf.backward_stats_reference(m, *planes)
    n0 = _kernels.LAUNCHES["backward"]
    path, stats = vf.backward_stats(m, *planes, return_path=return_path)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["backward"] == n0 + 1
    assert torch.equal(stats, stats_w)
    if return_path:
        assert torch.equal(path, path_w)
    else:
        assert path is None
    path_p, stats_p = vf.backward_stats_windowed_reference(m, *planes)
    assert torch.equal(path_p, path_w) and torch.equal(stats_p, stats_w)


@pytest.mark.parametrize("return_path", [True, False])
@pytest.mark.parametrize("origin32", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_backward_kernel_on_ragged_forward_planes(cuda, case, origin32,
                                                  return_path):
    """Lengths 0, 1, 2, 3 and L in one batch, on the forward twin's planes
    (which are the reference kernel's, bit for bit:
    tests/test_torch_viterbi_crossfeed.py)."""
    art, sm = locus_model(*case)
    m = TorchStructModel.from_payload(art, sm, cuda)
    seqs, lengths = _batch(case, 45, seed=13)
    lengths[:5] = torch.tensor([0, 1, 2, 3, seqs.shape[1]])
    seqs, lengths = seqs.to(cuda), lengths.to(cuda)
    _, bstate, oMI, oXH = vf.fused_forward_reference(m, seqs, lengths,
                                                     origin32)
    _assert_walk_equals_twin(m, (lengths, bstate, oMI, oXH), return_path)


@pytest.mark.parametrize("return_path", [True, False])
@pytest.mark.parametrize("dtype", [torch.int16, torch.int32])
def test_backward_kernel_on_random_planes(cuda, dtype, return_path):
    """Seeded random planes, every stored value in range: codes of 0 off
    column 0, sentinels that resolve outside the row, end states outside
    the model, and a diagonal share so that windows of every size occur."""
    art, sm = locus_model(*CASES[0])
    m = TorchStructModel.from_payload(art, sm, cuda)
    P, nb, B, L = m.P, m.nb, 67, 48
    mbit = vf.MBIT32 if dtype == torch.int32 else vf.MBIT16
    for seed in (3, 4, 5):
        rng = np.random.default_rng(seed)
        top = 2 * P + 2 * nb + 3
        oMI = rng.integers(0, top, (L, B, 2 * P))
        diagonal = rng.random((L, B, 2 * P)) < 0.8
        oMI = np.where(diagonal, np.arange(2 * P), oMI)
        match = (rng.random((L, B, 2 * P)) < 0.5) & (np.arange(2 * P) < P)
        oMI = oMI + mbit * match
        oXH = rng.integers(0, top, (L, B, 2 * nb))
        lengths = rng.integers(0, L + 1, B)
        lengths[:5] = [0, 1, 2, 3, L]
        bstate = rng.integers(-1, 2 * P + nb + 2, B)
        bstate[5:40] = rng.integers(1, P, 35)
        planes = (torch.as_tensor(lengths.astype(np.int32), device=cuda),
                  torch.as_tensor(bstate.astype(np.int32), device=cuda),
                  torch.as_tensor(oMI, device=cuda).to(dtype),
                  torch.as_tensor(oXH, device=cuda).to(dtype))
        _assert_walk_equals_twin(m, planes, return_path)


def test_read_stats_on_card_equal_cpu(cuda):
    case = CASES[1]
    art, sm = locus_model(*case)
    seqs, lengths = _batch(case, 33, seed=11)
    cpu = vf.viterbi_stats(TorchStructModel.from_payload(art, sm, "cpu"),
                           seqs, lengths, return_path=True)
    gpu = vf.viterbi_stats(TorchStructModel.from_payload(art, sm, cuda),
                           seqs.to(cuda), lengths.to(cuda), return_path=True)
    for k, v in cpu.items():
        np.testing.assert_array_equal(gpu[k].cpu().numpy(), v.numpy(),
                                      err_msg=k)


@pytest.mark.parametrize("units,copies", [(["ACG"] * 3, 40),
                                          (["CAGTT"] * 3, 7)])
def test_kernels_at_odd_shapes(cuda, units, copies):
    """P not a multiple of 32 (idle threads in the last warp) and more
    than 32 units (the unit chain and its argmax span several warps)."""
    left, right = rand_seq(5, 20), rand_seq(6, 21)
    art, sm = locus_model(units, left, right, copies, pos_bucket=1)
    m = TorchStructModel.from_payload(art, sm, cuda)
    assert m.P % 32 != 0
    seqs, lengths = _batch((units, left, right, copies), 37, seed=copies)
    seqs, lengths = seqs.to(cuda), lengths.to(cuda)
    got = vf.fused_forward(m, seqs, lengths)
    want = vf.fused_forward_reference(m, seqs, lengths)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    path, stats = vf.backward_stats(m, lengths, *want[1:])
    path_w, stats_w = vf.backward_stats_reference(m, lengths, *want[1:])
    assert torch.equal(path, path_w) and torch.equal(stats, stats_w)


# three loci of one shape (6 bp units, 8 bp flanks, 3 copies)
GROUP_CASES = [
    (["CAGCAG", "CAGCAG", "CAACAG"], "ACGTTGCA", "TTACGGAT", 3),
    (["TTGACC", "TTGACC", "TTGTCC"], "GGATCCAT", "CATGATCG", 3),
    (["ACCGTA", "ACCGTA", "ACCGTA"], "TGCATGCA", "GATTACAG", 3),
]


def _group(cuda, n_reads):
    """Three same-shape loci on the card, each with its own ragged batch
    (row counts differ; the padding rows have length 1)."""
    models = [TorchStructModel.from_payload(*locus_model(*case), cuda)
              for case in GROUP_CASES]
    batches = [_batch(case, n_reads - 3 * g, seed=40 + g)
               for g, case in enumerate(GROUP_CASES)]
    L = max(b.shape[1] for b, _ in batches)
    seqs = torch.zeros(len(batches), n_reads, L, dtype=torch.int8)
    lens = torch.ones(len(batches), n_reads, dtype=torch.int32)
    for g, (b, ln) in enumerate(batches):
        seqs[g, :b.shape[0], :b.shape[1]] = b
        lens[g, :b.shape[0]] = ln
    return models, seqs.to(cuda), lens.to(cuda)


@pytest.mark.parametrize("origin32", [False, True])
@pytest.mark.parametrize("n_reads", [7, 48])
def test_grouped_forward_kernel_matches_looped_twin(cuda, n_reads, origin32):
    models, seqs, lens = _group(cuda, n_reads)
    stack = TorchStructModel.stack(models)
    n0 = _kernels.LAUNCHES["forward"]
    got = vf.fused_forward_grouped(stack, seqs, lens, origin32)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["forward"] == n0 + 1
    for g, m in enumerate(models):
        want = vf.fused_forward_reference(m, seqs[g], lens[g], origin32)
        for x, w, name in zip(got, want, ("best", "bstate", "oMI", "oXH")):
            assert x.dtype == w.dtype, name
            assert torch.equal(x[g], w), (g, name)


def test_grouped_backward_kernel_matches_looped_twin(cuda):
    models, seqs, lens = _group(cuda, 33)
    stack = TorchStructModel.stack(models)
    planes = vf.fused_forward_grouped_reference(stack, seqs, lens)
    n0 = _kernels.LAUNCHES["backward"]
    path, stats = vf.backward_stats_grouped(stack, lens, *planes[1:])
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["backward"] == n0 + 1
    none, stats_only = vf.backward_stats_grouped(stack, lens, *planes[1:],
                                                 return_path=False)
    assert none is None and torch.equal(stats_only, stats)
    for g, m in enumerate(models):
        path_w, stats_w = vf.backward_stats_reference(
            m, lens[g], *(x[g] for x in planes[1:]))
        assert torch.equal(path[g], path_w), g
        assert torch.equal(stats[g], stats_w), g


def test_grouped_read_stats_on_card_equal_per_locus(cuda):
    from advntr_tpu_torch.engine import device_analytics as da
    models, seqs, lens = _group(cuda, 21)
    grouped = da.read_stats_grouped(models, seqs, lens, return_path=True)
    for g, m in enumerate(models):
        one = vf.viterbi_stats_reference(m, seqs[g], lens[g],
                                         return_path=True)
        for k, v in one.items():
            assert torch.equal(grouped[k][g], v), (g, k)
