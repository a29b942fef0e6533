"""The port's CUDA kernels (B1 forward with its wide entry, B2 backward
walk, the batched local alignment) against their plain PyTorch twins on
the card, at small sizes, per locus, as groups of same-shape loci in one
launch, and segment by segment with a carried state.

Needs a CUDA device and nvcc; skips elsewhere.  On the GPU host (no jax
there) run it without the suite's jax conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import functools
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


def _ask_layout(monkeypatch, cluster, ppt=None):
    """Make the wrapper lay the wide entry out with the cluster size and
    positions a thread asked for."""
    chosen = _kernels.wide_layout
    monkeypatch.setattr(_kernels, "wide_layout", functools.partial(
        chosen, cluster=cluster, ppt=ppt))


@pytest.mark.parametrize("units,copies", [(["ACG"] * 3, 40),
                                          (["CAGTT"] * 3, 7)])
def test_kernels_at_odd_shapes(cuda, units, copies, monkeypatch):
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
    # the wide entry in clusters of 1 and 3: a short last slice whose last
    # warp idles past P
    for cluster in (1, 3):
        with monkeypatch.context() as mp:
            _ask_layout(mp, cluster)
            wide = _kernels.forward(m.as_stack(), seqs[None], lengths[None],
                                    wide=True)
        for g, w in zip(wide, want):
            assert torch.equal(g[0], w)
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


# ---- segments, the wide entry, local alignment -----------------------------

@pytest.mark.parametrize("origin32", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_wide_entry_equals_first_entry(cuda, case, origin32):
    """The wide entry of B1 on a model the first entry takes: the same
    best, end states and planes, bit for bit, and each counted as its own
    launch."""
    art, sm = locus_model(*case)
    m = TorchStructModel.from_payload(art, sm, cuda)
    seqs, lengths = _batch(case, 41, seed=3)
    lengths[:3] = torch.tensor([1, 2, seqs.shape[1]])
    seqs, lengths = seqs.to(cuda), lengths.to(cuda)
    stack = m.as_stack()
    n0 = dict(_kernels.LAUNCHES)
    narrow = _kernels.forward(stack, seqs[None], lengths[None], origin32,
                              wide=False)
    wide = _kernels.forward(stack, seqs[None], lengths[None], origin32,
                            wide=True)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["forward"] == n0["forward"] + 1
    assert _kernels.LAUNCHES["forward_wide"] == n0["forward_wide"] + 1
    want = vf.fused_forward_reference(m, seqs, lengths, origin32)
    for a, b, w in zip(narrow, wide, want):
        assert torch.equal(a, b) and torch.equal(a[0], w)


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("segment", [3, 64])
@pytest.mark.parametrize("case", CASES)
def test_forward_segments_carry_the_twin_state(cuda, case, segment, wide):
    """Both entries of B1 run segment by segment: each segment's planes
    and exit state equal the twin's, and the last exit gives the whole
    read's score and end state; the pass without planes leaves the same
    states behind."""
    art, sm = locus_model(*case)
    m = TorchStructModel.from_payload(art, sm, cuda)
    stack = m.as_stack()
    seqs, lengths = _batch(case, 23, seed=5)
    lengths[:2] = torch.tensor([1, 2])
    seqs, lengths = seqs.to(cuda), lengths.to(cuda)
    best, bstate, oMI, oXH = vf.fused_forward_reference(m, seqs, lengths)
    state = bare = twin = None
    for c0 in range(0, seqs.shape[1], segment):
        cols = seqs[:, c0:c0 + segment]
        b, e, sMI, sXH, state = _kernels.forward_segment(
            stack, cols[None], lengths[None], False, state, c0, True, wide)
        _, _, no1, no2, bare = _kernels.forward_segment(
            stack, cols[None], lengths[None], False, bare, c0, False, wide)
        twin, _, _ = vf.fused_forward_segment_reference(
            m, cols, lengths, False, twin, c0, planes=False)
        assert no1 is None and no2 is None
        assert torch.equal(sMI[0], oMI[c0:c0 + segment])
        assert torch.equal(sXH[0], oXH[c0:c0 + segment])
        for kept in (state, bare):
            assert torch.equal(kept[0][0], twin[0])
            assert torch.equal(kept[1][0], twin[1])
    assert torch.equal(b[0], best) and torch.equal(e[0], bstate)


@pytest.mark.parametrize("origin32", [False, True])
@pytest.mark.parametrize("segment", [3, 64])
def test_checkpointed_path_on_card_equals_whole_planes(cuda, segment,
                                                       origin32):
    """read_stats_ckpt on the card (B1 with the carry, B2 over column
    ranges) against the whole-plane kernels and the twins on the CPU."""
    from advntr_tpu_torch.engine import device_analytics as da
    case = CASES[1]
    art, sm = locus_model(*case)
    m = TorchStructModel.from_payload(art, sm, cuda)
    seqs, lengths = _batch(case, 29, seed=8)
    lengths[:2] = torch.tensor([1, 2])
    whole = da.read_stats(m, seqs.to(cuda), lengths.to(cuda),
                          return_path=True, origin32=origin32)
    n0 = _kernels.LAUNCHES["backward"]
    out = da.read_stats_ckpt(m, seqs.to(cuda), lengths.to(cuda),
                             return_path=True, segment=segment,
                             origin32=origin32)
    n_seg = -(-seqs.shape[1] // segment)
    assert _kernels.LAUNCHES["backward"] == n0 + n_seg
    cpu = da.read_stats_ckpt(TorchStructModel.from_payload(art, sm, "cpu"),
                             seqs, lengths, return_path=True,
                             segment=segment, origin32=origin32)
    for k, v in whole.items():
        assert torch.equal(out[k], v), k
        assert torch.equal(out[k].cpu(), cpu[k]), k


def test_wide_model_on_card(cuda):
    """A model past the first entry's limits (P > 1024, C > 128) and past
    int16 origins: B1 takes the wide entry by itself, B2 reads its state
    tables unstaged only past 12,288 states, and whole planes, segments and
    twins agree bit for bit."""
    from advntr_tpu_torch.engine import device_analytics as da
    from advntr_tpu_torch.engine.simulate import mutate
    units, copies = ["ACGTA"] * 3, 290
    left, right = rand_seq(7, 60), rand_seq(8, 60)
    art, sm = locus_model(units, left, right, copies, pos_bucket=128,
                          unit_bucket=32)
    m = TorchStructModel.from_payload(art, sm, cuda)
    assert m.P > _kernels.MAX_THREADS and m.C > _kernels.MAX_UNITS
    rng = random.Random(3)
    hap = left + "ACGTA" * 40 + right
    reads = [mutate(r, 0.05, rng) for r in
             (hap, hap[10:200], hap[5:150], hap[30:])] + ["A"]
    rows = [dna.encode(r) for r in reads]
    batch, lens = dna.pad_batch(rows, pad_to=256, multiple=32)
    seqs, lengths = (torch.as_tensor(batch, device=cuda),
                     torch.as_tensor(lens, device=cuda))
    n0 = dict(_kernels.LAUNCHES)
    got = vf.fused_forward(m, seqs, lengths)
    assert _kernels.LAUNCHES["forward_wide"] == n0["forward_wide"] + 1
    assert _kernels.LAUNCHES["forward"] == n0["forward"]
    want = vf.fused_forward_reference(m, seqs, lengths)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    path, stats = vf.backward_stats(m, lengths, *want[1:])
    path_w, stats_w = vf.backward_stats_reference(m, lengths, *want[1:])
    assert torch.equal(path, path_w) and torch.equal(stats, stats_w)
    whole = da.read_stats(m, seqs, lengths, return_path=True)
    out = da.read_stats_ckpt(m, seqs, lengths, return_path=True, segment=64)
    for k, v in whole.items():
        assert torch.equal(out[k], v), k


def _cluster_batches(hap, n_batches, seed):
    """(seqs (G, B, L), lengths (G, B)): noisy, cut and one-base reads of
    ``hap``, a batch for each locus of the group, padded to one L."""
    from advntr_tpu_torch.engine.simulate import mutate
    rng = random.Random(seed)
    batches = []
    for _ in range(n_batches):
        a = rng.randint(5, 40)
        reads = [mutate(hap, 0.05, rng), hap[a:], hap[:len(hap) - a],
                 mutate(hap[a:a + 90], 0.1, rng), "A", hap[:2], hap]
        batches.append([dna.encode(r) for r in reads])
    L = max(len(r) for rows in batches for r in rows)
    padded = [dna.pad_batch(rows, pad_to=L, multiple=32) for rows in batches]
    return (torch.as_tensor(np.stack([b for b, _ in padded])),
            torch.as_tensor(np.stack([n for _, n in padded])))


@pytest.mark.parametrize("origin32", [False, True])
@pytest.mark.parametrize("copies,cluster,ppt,flank", [
    (25, 1, 1, 60), (25, 2, 1, 60), (25, 4, 1, 60), (25, 8, 1, 60),
    (40, 12, 1, 60), (60, 16, 1, 60), (170, 16, 2, 60), (290, 1, 2, 60),
    (20, 2, 1, 1100), (20, 3, 1, 1100)])
def test_wide_entry_cluster_sizes_match_twin(cuda, copies, cluster, ppt,
                                             flank, origin32, monkeypatch):
    """B1's wide entry with the cluster size and positions a thread asked
    for, on a group of two loci: whole reads and 64-column segments (from
    the entry state, with and without planes) against the twins, bit for
    bit.  The models put slice edges inside the flanks' delete runs and
    between unit ends, and the rounds' shifts wrap at P into the last CTA;
    12 and 16 CTAs are past the portable cluster size (16 also with two
    positions a thread and 192 units over several warps), one CTA over P
    1,664 holds two positions a thread, and a 1,100-base flank needs 11
    doubling rounds: the two past the halo's run across the cluster, the
    last with its weights in shared memory."""
    units, left, right = ["ACGTA"] * 3, rand_seq(7, flank), rand_seq(8, 60)
    art, sm = locus_model(units, left, right, copies, pos_bucket=128,
                          unit_bucket=32)
    m = TorchStructModel.from_payload(art, sm, cuda)
    _ask_layout(monkeypatch, cluster, ppt)
    lay = _kernels.wide_layout(m.P, m.nb, m.C, m.Wd.shape[0],
                               m.Wu.shape[0])
    assert (lay.cluster, lay.ppt) == (cluster, ppt)
    assert _kernels.wide_rounds(m.P, m.Wd.shape[0]) == (11 if flank > 1024
                                                        else 6)
    stack = TorchStructModel.stack([m, m])
    hap = left + "ACGTA" * min(copies - 5, 60) + right
    seqs, lengths = _cluster_batches(hap, 2, seed=copies + cluster)
    seqs, lengths = seqs.to(cuda), lengths.to(cuda)
    n0 = _kernels.LAUNCHES["forward_wide"]
    got = _kernels.forward(stack, seqs, lengths, origin32, wide=True)
    assert _kernels.LAUNCHES["forward_wide"] == n0 + 1
    for g in range(2):
        want = vf.fused_forward_reference(m, seqs[g], lengths[g], origin32)
        for x, w in zip(got, want):
            assert x[g].dtype == w.dtype and torch.equal(x[g], w)
    state = bare = None
    twins = [None, None]
    for c0 in range(0, seqs.shape[2], 64):
        cols = seqs[:, :, c0:c0 + 64].contiguous()
        out = _kernels.forward_segment(stack, cols, lengths, origin32, state,
                                       c0, True, wide=True)
        no = _kernels.forward_segment(stack, cols, lengths, origin32, bare,
                                      c0, False, wide=True)
        state, bare = out[4], no[4]
        assert no[2] is None and no[3] is None
        for g in range(2):
            twins[g], tMI, tXH = vf.fused_forward_segment_reference(
                m, cols[g], lengths[g], origin32, twins[g], c0)
            assert torch.equal(out[2][g], tMI) and torch.equal(out[3][g], tXH)
            for kept in (state, bare):
                assert torch.equal(kept[0][g], twins[g][0])
                assert torch.equal(kept[1][g], twins[g][1])
    for g in range(2):
        assert torch.equal(out[0][g], got[0][g])
        assert torch.equal(out[1][g], got[1][g])


def test_walk_reads_unstaged_tables(cuda):
    """More than MAX_STRUCT states: the walk reads region and unit from
    device memory.  The model is a small one whose state tables are padded
    past the limit with states no path visits."""
    import dataclasses
    art, sm = locus_model(*CASES[0])
    m = TorchStructModel.from_payload(art, sm, cuda)
    seqs, lengths = _batch(CASES[0], 19, seed=2)
    seqs, lengths = seqs.to(cuda), lengths.to(cuda)
    _, bstate, oMI, oXH = vf.fused_forward_reference(m, seqs, lengths)
    path_w, stats_w = vf.backward_stats_reference(m, lengths, bstate, oMI,
                                                  oXH)
    stack = m.as_stack()
    # the walk indexes the tables by state and only their declared length
    # decides staging, so longer tables with the same leading entries walk
    # the same paths
    extra = _kernels.MAX_STRUCT + 1 - stack.region.shape[1]
    grow = lambda t: torch.cat(
        [t, torch.zeros(1, extra, dtype=t.dtype, device=cuda)], dim=1)
    big = dataclasses.replace(stack, region=grow(stack.region),
                              unit=grow(stack.unit))
    # the wrapper ties the tables' length to (P, nb), so the C entry point
    # is called directly here
    lib = _kernels.build()["viterbi_backward.cu"]
    path = torch.empty(1, seqs.shape[0], seqs.shape[1], dtype=torch.int32,
                       device=cuda)
    stats = torch.empty(1, seqs.shape[0], 16, dtype=torch.int32, device=cuda)
    l32, b32 = lengths.int().contiguous(), bstate.int().contiguous()
    code = lib.advntr_viterbi_backward(
        l32.data_ptr(), b32.data_ptr(), oMI.data_ptr(), oXH.data_ptr(),
        big.region.data_ptr(), big.unit.data_ptr(), path.data_ptr(),
        stats.data_ptr(), None, None, 1, seqs.shape[0], seqs.shape[1], m.P,
        m.nb, big.region.shape[1], 0, vf.MBIT16, 1, 0,
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert code == 0
    assert torch.equal(path[0], path_w) and torch.equal(stats[0], stats_w)


@pytest.mark.parametrize("L,probe_len", [(3008, 100), (12288, 100),
                                         (512, 128), (256, 7)])
def test_local_align_kernel_matches_plain(cuda, L, probe_len):
    """(score, end) of the kernel equal the plain scan's exactly, on
    ragged reads (lengths 1 and L among them) that carry noisy copies of
    the probe, forward and reversed, one pass a launch."""
    from advntr_tpu_torch.ops import align
    rng = np.random.default_rng(L + probe_len)
    B = 12
    reads = rng.integers(0, 4, (B, L)).astype(np.int8)
    probe = rng.integers(0, 4, probe_len).astype(np.int8)
    lengths = rng.integers(probe_len, L + 1, B).astype(np.int32)
    lengths[:2] = [L, 1]
    for i in range(2, B):
        at = int(rng.integers(0, lengths[i] - probe_len + 1))
        reads[i, at:at + probe_len] = probe
        flips = rng.random(probe_len) < 0.08
        reads[i, at:at + probe_len][flips] = rng.integers(0, 4, flips.sum())
    for r, p in ((reads, probe),
                 (np.stack([np.concatenate([row[:n][::-1], row[n:]])
                            for row, n in zip(reads, lengths)]),
                  probe[::-1].copy())):
        args = [torch.as_tensor(x, device=cuda) for x in (r, lengths, p)]
        n0 = _kernels.LAUNCHES["local_align"]
        score, end = align.local_align_batch(*args)
        torch.cuda.synchronize()
        assert _kernels.LAUNCHES["local_align"] == n0 + 1
        score_w, end_w = align.local_align_batch_reference(*args)
        assert torch.equal(score, score_w) and torch.equal(end, end_w)
        assert int(score[2:].min()) > probe_len // 2


@pytest.mark.parametrize("chunks", [None, 1, 3, 40])
def test_local_align_passes_in_one_launch_match_plain(cuda, chunks,
                                                      monkeypatch):
    """Four passes in one launch (two probes of different lengths, each
    forward against the reads and reversed against the reversed reads, as
    anchor_probes_batch runs them) against the plain scan, pass by pass;
    the reads split as the wrapper chooses and into 1, 3 and 40 chunks
    (40: chunks shorter than their warm-up), with noisy copies of the
    probes across the chunk borders and exact copies in two chunks."""
    from advntr_tpu_torch.ops import align
    if chunks is not None:
        monkeypatch.setattr(_kernels, "align_chunks",
                            lambda *a: chunks)
    rng = np.random.default_rng(31)
    B, L = 24, 4000
    probes = [rng.integers(0, 4, 100).astype(np.int8),
              rng.integers(0, 4, 37).astype(np.int8)]
    reads = rng.integers(0, 4, (B, L)).astype(np.int8)
    lengths = rng.integers(1, L + 1, B).astype(np.int32)
    lengths[:3] = [L, 1, 0]
    for i in range(3, B):
        p = probes[i % 2]
        at = int(rng.integers(0, max(1, lengths[i] - len(p))))
        if i % 3 == 0:            # across a border of 3 or 40 chunks
            at = max(0, min((L // 3 if i % 2 else L // 40) - 20,
                            lengths[i] - len(p)))
        reads[i, at:at + len(p)] = p
        flips = rng.random(len(p)) < 0.08
        reads[i, at:at + len(p)][flips] = rng.integers(0, 4, flips.sum())
    reads[4, 10:110] = probes[0]
    reads[4, L - 200:L - 100] = probes[0]
    lengths[4] = L
    rev = np.stack([np.concatenate([row[:n][::-1], row[n:]])
                    for row, n in zip(reads, lengths)])
    table = np.zeros((4, 128), dtype=np.int8)
    for i, p in enumerate(probes):
        table[i, :len(p)] = p
        table[2 + i, :len(p)] = p[::-1]
    on = lambda x: torch.as_tensor(x, device=cuda)
    plen, rsel = [100, 37, 100, 37], [0, 0, 1, 1]
    n0 = _kernels.LAUNCHES["local_align"]
    score, end = align.local_align_passes(
        on(np.stack([reads, rev])), on(lengths), on(table), plen, rsel)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["local_align"] == n0 + 1
    for i in range(4):
        r = (reads, rev)[rsel[i]]
        s_w, e_w = align.local_align_batch_reference(
            on(r), on(lengths), on(table[i, :plen[i]]))
        assert torch.equal(score[i], s_w) and torch.equal(end[i], e_w), i
    assert (int(score[0, 4]), int(end[0, 4])) == (100, 110)


def test_anchor_probes_batch_on_card_equals_cpu(cuda):
    """The finder's one launch a locus: both flanks in both directions on
    the card give the CPU's (score, start, end) triples."""
    from advntr_tpu_torch.ops import align
    rng = random.Random(41)
    left = rand_seq(51, 100)
    right = rand_seq(52, 100)
    reads = []
    for _ in range(14):
        hap = rand_seq(rng.randint(0, 99), rng.randint(200, 2500))
        cut = rng.randint(0, len(hap))
        read = hap[:cut] + left + hap[cut:cut + 300] + right + hap[cut:]
        reads.append(read if rng.random() < 0.5 else dna.revcomp(read))
    rows = [dna.encode(r) for r in reads]
    probes = [dna.encode(left), dna.encode(right)]
    n0 = _kernels.LAUNCHES["local_align"]
    got = align.anchor_probes_batch(rows, probes, device=cuda)
    assert _kernels.LAUNCHES["local_align"] == n0 + 1
    assert got == align.anchor_probes_batch(rows, probes, device="cpu")


@pytest.mark.parametrize("P,C", [(20480, 3414), (32768, 5462)])
def test_wide_entry_with_units_in_device_memory_matches_twin(cuda, P, C):
    """Windows past 16,384 positions with 6 bp motifs (random tables, no
    host compile): the per-unit arrays do not fit in shared memory and
    each CTA keeps them in its slice of device memory.  Two 6-column
    segments, the second from the first's exit state, against the twin:
    planes, exit states, best and bstate bit for bit."""
    from advntr_tpu_torch.synthetic import random_wide_model
    m = random_wide_model(P, C, seed=P, device=cuda)
    stack = m.as_stack()
    lay = _kernels.wide_layout(P, m.nb, C, m.Wd.shape[0], m.Wu.shape[0])
    assert lay.unit_words > 0 and lay.ppt == 2
    rng = np.random.default_rng(P)
    seqs = torch.as_tensor(rng.integers(0, 4, (1, 2, 12)), dtype=torch.int8,
                           device=cuda)
    lengths = torch.tensor([[12, 5]], dtype=torch.int32, device=cuda)
    state = twin = None
    n0 = _kernels.LAUNCHES["forward_wide"]
    for c0 in (0, 6):
        cols = seqs[:, :, c0:c0 + 6].contiguous()
        out = _kernels.forward_segment(stack, cols, lengths, False, state, c0)
        twin, tMI, tXH = vf.fused_forward_segment_reference(
            m, cols[0], lengths[0], False, twin, c0)
        assert torch.equal(out[2][0], tMI) and torch.equal(out[3][0], tXH)
        assert torch.equal(out[4][0][0], twin[0])
        assert torch.equal(out[4][1][0], twin[1])
        state = out[4]
    assert _kernels.LAUNCHES["forward_wide"] == n0 + 2
    best, bstate = vf.forward_state_best(m, twin)
    assert torch.equal(out[0][0], best) and torch.equal(out[1][0], bstate)


def test_run_device_paths_equal_twin_at_cstb_cell(cuda):
    """The engine's own call with the path asked for (``-fs`` and ``-u``
    decode through it): one B1 and one B2 launch at the CSTB cell (the
    engine's padding, P 512; 4,096 reads of 150 bp, L 160), paths and
    statistics bit-identical to the plain twins on the card."""
    from advntr_tpu_torch.engine.finder import LocusModelCache, VNTRFinder
    from advntr_tpu_torch.synthetic import (build_cstb_locus, encode_reads,
                                            simulate_cstb_reads)
    graph, art, left, right, pattern = build_cstb_locus(150)
    lm = LocusModelCache(device=cuda)._build(graph, art)
    assert (lm.art.n_states, lm.model.P) == (927, 512)
    batch, lengths = encode_reads(
        simulate_cstb_reads(left, pattern, right, 150, 4096, seed=9), 150)

    class _Finder:
        device = cuda
        run_device = VNTRFinder.run_device

    n0 = dict(_kernels.LAUNCHES)
    got = _Finder().run_device(lm, batch, lengths, return_paths=True)
    assert _kernels.LAUNCHES["forward"] == n0["forward"] + 1
    assert _kernels.LAUNCHES["backward"] == n0["backward"] + 1
    want = vf.viterbi_stats_reference(
        lm.model, torch.as_tensor(batch, device=cuda),
        torch.as_tensor(lengths, device=cuda), return_path=True)
    assert got["path"].shape == batch.shape
    for k in vf.STAT_KEYS + ("path",):
        np.testing.assert_array_equal(got[k], want[k].cpu().numpy(),
                                      err_msg=k)
    np.testing.assert_allclose(got["logp"], want["logp"].cpu().numpy(),
                               rtol=1e-4, atol=1e-2)


def _sum_model():
    """A small model's posterior tables and insert mask, and 24 seeded
    reads."""
    from advntr_tpu_torch.models.graph import build_read_matcher
    from advntr_tpu_torch.models.profile import profile_for_repeats
    from advntr_tpu_torch.ops.posterior import indel_model
    units, left, right, copies = CASES[1]
    trans, emis = profile_for_repeats(units, 0.05)
    host, occ = indel_model(
        build_read_matcher(left, right, trans, emis, copies, 0.05))
    return host, occ, _batch(CASES[1], 24, seed=21)


def test_posterior_and_baum_welch_on_card_equal_cpu(cuda):
    """ops/posterior.py and ops/baum_welch.py are plain PyTorch: on the
    card they agree with the same functions on the CPU within rtol 1e-4
    (float32 sums in another order; the products in full float32)."""
    from advntr_tpu_torch.ops.baum_welch import baum_welch_stats
    from advntr_tpu_torch.ops.posterior import (clean_neg,
                                                posterior_indel_batch)
    host, occ, (seqs, lengths) = _sum_model()
    cpu = torch.device("cpu")
    for name, fn, n_tables in (("posterior", posterior_indel_batch, 7),
                               ("baum_welch", baum_welch_stats, 4)):
        outs = []
        for dev in (cpu, cuda):
            args = [clean_neg(x, dev) for x in host[:n_tables]]
            if name == "posterior":
                args.append(torch.as_tensor(occ, device=dev))
            outs.append(fn(*args, seqs.to(dev), lengths.to(dev)))
        for k, v in outs[0].items():
            assert outs[1][k].device.type == "cuda", (name, k)
            np.testing.assert_allclose(outs[1][k].cpu().numpy(), v.numpy(),
                                       rtol=1e-4, atol=1e-5,
                                       err_msg=f"{name} {k}")


# ---- model management: the DNN gate, addmodel, trained-HMM models ----------

def test_dnn_gate_on_card_equals_cpu(cuda):
    """The gate's embeddings on the card equal the CPU's bit for bit; its
    predictions agree within 1e-6 with equal decisions; three epochs of
    training on the card from parameters carried from the CPU end within
    atol 1e-4 of the CPU's, for both widths."""
    from advntr_tpu_torch.engine import deep_recruitment as dr
    rng = random.Random(31)
    reads = ["".join(rng.choice("ACGTN") for _ in range(rng.randint(1, 150)))
             for _ in range(60)] + [rand_seq(40 + i, 150) for i in range(60)]
    batch, lengths = dna.pad_batch([dna.encode(s) for s in reads], multiple=8)
    cpu = torch.device("cpu")
    emb = dr.embed_batch(batch, lengths, cpu)
    card = dr.embed_batch(batch, lengths, cuda)
    assert card.is_cuda and torch.equal(card.cpu(), emb)
    labels = np.array([i % 2 for i in range(len(reads))])
    for second in (0, 50):
        start = dr.init_params(second_layer=second,
                               generator=torch.Generator().manual_seed(3))
        carried = start.to_numpy()
        p_host = dr.predict(start, emb)
        p_card = dr.predict(dr.RecruitmentMLP.from_numpy(carried, cuda),
                            card).cpu()
        torch.testing.assert_close(p_card, p_host, rtol=0, atol=1e-6)
        assert torch.equal(p_card[:, 0] > p_card[:, 1],
                           p_host[:, 0] > p_host[:, 1])
        trained = {}
        orig = dr.init_params
        dr.init_params = lambda first_layer=100, second_layer=0, \
            generator=None: dr.RecruitmentMLP.from_numpy(carried)
        try:
            for dev, x in ((cpu, emb), (cuda, card)):
                trained[dev.type] = dr.train(
                    x, labels, epochs=3, second_layer=second,
                    device=dev).to_numpy()
        finally:
            dr.init_params = orig
        for k, v in trained["cpu"].items():
            np.testing.assert_allclose(trained["cuda"][k], v, rtol=0,
                                       atol=1e-4, err_msg=k)


def test_dense_fallback_on_card_equals_cpu(cuda):
    """An imported topology the structured extractor refuses: the dense
    fallback on the card gives the CPU's statistics and paths, logp
    within rtol 1e-4 / atol 1e-2, with its rows in chunks."""
    from advntr_tpu_torch.engine import device_analytics as da
    from advntr_tpu_torch.engine.finder import LocusModelCache
    from advntr_tpu_torch.models.compiler import compile_graph
    from advntr_tpu_torch.synthetic import (build_cstb_locus, encode_reads,
                                            refused_topology,
                                            simulate_cstb_reads)
    graph, _, left, right, pattern = build_cstb_locus(60)
    g = refused_topology(graph)
    art = compile_graph(g)
    reads = simulate_cstb_reads(left, pattern, right, 60, 40)
    reads[2] = reads[2][:1]
    batch, lengths = encode_reads(reads, 64)
    outs = []
    for dev in (torch.device("cpu"), cuda):
        lm = LocusModelCache(device=dev)._build_imported(g, art)
        assert lm.model is None and lm.dense.log_T.device.type == dev.type
        n = lm.dense.n_states
        outs.append(da.read_stats_dense(
            lm.dense, torch.as_tensor(batch, device=dev),
            torch.as_tensor(lengths, device=dev), return_path=True,
            chunk_bytes=16 * 4 * n * n))
    want, got = outs
    torch.testing.assert_close(got["logp"].cpu(), want["logp"], rtol=1e-4,
                               atol=1e-2)
    for k in want:
        if k != "logp":
            assert torch.equal(got[k].cpu(), want[k]), k


def test_addmodel_threshold_on_card_equals_cpu(cuda, tmp_path):
    """``train_classifier_threshold`` on a small chromosome with planted
    decoys: the kernels on the card and the twins on the CPU score the
    same reads within rtol 1e-4 / atol 1e-2 and fit the same threshold."""
    from advntr_tpu_torch.engine import training
    from advntr_tpu_torch.io.fasta import load_chromosome
    from advntr_tpu_torch.models.reference_vntr import ReferenceVNTR
    from advntr_tpu_torch.synthetic import write_addmodel_reference
    fa, chrom, start, end, pattern = write_addmodel_reference(
        str(tmp_path), length=200_000, copies=6, fragments=3)
    seq = load_chromosome(fa, chrom)
    fits = []
    orig = training.find_recruitment_score_threshold

    def record(true, false):
        fits.append((true, false))
        return orig(true, false)

    training.find_recruitment_score_threshold = record
    try:
        scaled = []
        for dev in (cuda, torch.device("cpu")):
            ref = ReferenceVNTR(1, pattern, start, chrom, None, None,
                                int((end - start) / len(pattern) + 5), seq)
            ref.init_from_vntrseek_data()
            n0 = dict(_kernels.LAUNCHES)
            scaled.append(training.train_classifier_threshold(
                ref, seq, 100, device=dev))
            if dev.type == "cuda":
                assert _kernels.LAUNCHES["forward"] > n0["forward"]
    finally:
        training.find_recruitment_score_threshold = orig
    assert scaled[0] == scaled[1] != 0
    (true_c, false_c), (true_h, false_h) = fits
    assert len(false_c) == len(false_h) > 0
    np.testing.assert_allclose(true_c, true_h, rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(false_c, false_h, rtol=1e-4, atol=1e-2)


@pytest.mark.parametrize("refused", [False, True])
def test_trained_hmm_genotype_on_card_equals_cpu(cuda, tmp_path, refused):
    """``genotype`` of the CSTB 2/5 fixture with ``trained_hmms_dir``
    (structured, or a refused topology through the dense fallback): the
    same text on the card and on the CPU."""
    import dataclasses
    import io
    from advntr_tpu_torch.config import Config
    from advntr_tpu_torch.engine.analyzer import GenomeAnalyzer
    from advntr_tpu_torch.models.db import load_unique_vntrs_data
    from advntr_tpu_torch.synthetic import (write_cstb_sample,
                                            write_trained_hmms)
    db, bam = write_cstb_sample(str(tmp_path), coverage=20)
    config = dataclasses.replace(
        Config(), trained_hmms_dir=write_trained_hmms(
            str(tmp_path), db, 100, refused=refused))
    refs = load_unique_vntrs_data(db)
    texts = []
    for dev in ("cuda", "cpu"):
        (tmp_path / dev).mkdir()
        out = io.StringIO()
        analyzer = GenomeAnalyzer(refs, [r.id for r in refs],
                                  str(tmp_path / dev) + "/", "text", False,
                                  None, bam, config=config, out=out,
                                  device=dev)
        analyzer.find_repeat_counts_from_alignment_file(bam)
        texts.append(out.getvalue())
    assert texts[0] == texts[1]
    assert texts[0].split() == ["301645", "2/5"]


@pytest.mark.parametrize("n_devices,expect", [(2, (2, 1)), (8, (4, 2))])
def test_sharded_dispatch_on_card_equals_one_launch(cuda, n_devices,
                                                    expect):
    """A group of 4 same-shape loci split over explicit meshes of this
    card (and of every card, where more than one is visible): the
    statistics equal one unsharded launch bit for bit, one launch of each
    kernel a shard."""
    from advntr_tpu_torch.engine import device_analytics as da
    from advntr_tpu_torch.parallel import mesh
    cases = [(["CAGCAG", "CAGCAG", "CAACAG"], "ACGTTGCA", "TTACGGAT", 3),
             (["TTGACC", "TTGACC", "TTGTCC"], "GGATCCAT", "CATGATCG", 3),
             (["ACCGTA", "ACCGTA", "ACCGTA"], "TGCATGCA", "GATTACAG", 3),
             (["GATCGA", "GATCGA", "GTTCGA"], "CCGTAGCA", "ATGCCGTA", 3)]
    models = [TorchStructModel.from_payload(*locus_model(*c), cuda)
              for c in cases]
    batches = [_batch(c, 64, seed=g) for g, c in enumerate(cases)]
    L = max(b.shape[1] for b, _ in batches)
    seqs = torch.stack([torch.nn.functional.pad(b, (0, L - b.shape[1]))
                        for b, _ in batches]).to(cuda)
    lens = torch.stack([n for _, n in batches]).to(cuda)
    whole = da.read_stats_grouped(models, seqs, lens)
    meshes = [mesh.panel_mesh(4, 64, devices=[cuda] * n_devices)]
    if torch.cuda.device_count() > 1:
        meshes.append(mesh.panel_mesh(4, 64))
    assert (meshes[0].n_loci, meshes[0].n_reads) == expect
    for m in meshes:
        _kernels.reset_launches()
        got = mesh.sharded_grouped_read_stats(m, models, seqs, lens)
        torch.cuda.synchronize()
        shards = m.n_loci * m.n_reads
        assert _kernels.LAUNCHES["forward"] == shards
        assert _kernels.LAUNCHES["backward"] == shards
        for k, v in whole.items():
            assert got[k].device == seqs.device and torch.equal(got[k], v), k


def test_mutated_reference_sweep_on_card_equals_cpu(cuda):
    """The sweep with its default finder (on the card) gives the rows of
    the same sweep with a CPU finder, through B1 and B2."""
    from advntr_tpu_torch.config import Config
    from advntr_tpu_torch.engine.evaluation import mutated_reference_sweep
    from advntr_tpu_torch.engine.finder import VNTRFinder
    from advntr_tpu_torch.synthetic import cstb_chromosome
    ref, chrom = cstb_chromosome()
    kw = dict(desired_counts=[2, 4], coverage=20, read_length=100, seed=3)
    _kernels.reset_launches()
    card = mutated_reference_sweep(ref, chrom, **kw)
    assert _kernels.LAUNCHES["forward"] > 0
    assert _kernels.LAUNCHES["backward"] > 0
    cpu = mutated_reference_sweep(
        ref, chrom, finder=VNTRFinder(ref, Config(), device="cpu"), **kw)
    assert card["rows"] == cpu["rows"]


def test_kernels_launch_on_their_tensors_card(cuda):
    """C-4: with cuda:0 current, B1 (both entries), B2 and local_align
    handed cuda:1 tensors launch on cuda:1 and give cuda:0's results bit
    for bit; tensors on two cards in one call raise.  Needs two cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    art, sm = locus_model(*CASES[0])
    seqs, lengths = _batch(CASES[0], 16, seed=3)
    probes = torch.as_tensor(dna.encode("CAGCAGCAGCAACAG"))[None]
    out = {}
    for index in (0, 1):
        dev = torch.device("cuda", index)
        with torch.cuda.device(0):
            s = TorchStructModel.from_payload(art, sm, dev).as_stack()
            q, n = seqs[None].to(dev), lengths[None].to(dev)
            best, bstate, oMI, oXH = _kernels.forward(s, q, n)
            wide = _kernels.forward(s, q, n, wide=True)
            path, stats = _kernels.backward(s, n, bstate, oMI, oXH)
            score, end = _kernels.local_align_passes(
                q.to(torch.int8), n[0], probes.to(dev, torch.int8), [15],
                [0])
            assert torch.cuda.current_device() == 0
        torch.cuda.synchronize(dev)
        out[index] = [x.cpu() for x in (best, bstate, oMI, oXH, *wide,
                                         path, stats, score, end)]
    for a, b in zip(out[0], out[1]):
        assert torch.equal(a, b)
    s0 = TorchStructModel.from_payload(art, sm, torch.device("cuda", 0))
    with pytest.raises(ValueError, match="2 devices"):
        _kernels.forward(s0.as_stack(), seqs[None].to("cuda:1"),
                         lengths[None].to("cuda:1"))


def test_struct_path_on_card_equals_cpu(cuda):
    """The structured decoder (plain torch, ADVNTR_TPU_KERNEL=struct) on
    the card gives the CPU's results bit for bit: whole reads, a group of
    two loci, and the checkpointed traceback."""
    from advntr_tpu_torch.ops.viterbi_ckpt import viterbi_struct_checkpointed
    from advntr_tpu_torch.ops.viterbi_struct import (StructDeviceModel,
                                                     viterbi_struct_batch)
    built = [locus_model(*c) for c in
             (CASES[0], (["TTGACC", "TTGACC", "TTGTCC"], "GGATCCAT",
                         "CATGATCG", 3))]
    seqs, lengths = _batch(CASES[0], 32, seed=7)
    sls = torch.tensor([sm.suffix_last for _, sm in built])
    for dev in (torch.device("cpu"), cuda):
        models = [StructDeviceModel.from_struct(sm, art, dev)
                  for art, sm in built]
        q, n = seqs.to(dev), lengths.to(dev)
        one = viterbi_struct_batch(models[0], q, n, built[0][1].suffix_last)
        group = viterbi_struct_batch(StructDeviceModel.stack(models),
                                     torch.stack([q, q]),
                                     torch.stack([n, n]), sls.to(dev))
        ckpt = viterbi_struct_checkpointed(models[0], q, n,
                                           built[0][1].suffix_last,
                                           segment=5)
        got = [x.cpu() for x in (*one, *group, *ckpt)]
        if dev.type == "cpu":
            want = got
    for a, b in zip(got, want):
        assert torch.equal(a, b)
