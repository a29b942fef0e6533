"""The port's fused Viterbi pipeline (plain PyTorch twins on the CPU)
against the JAX reference: the Pallas kernel pair in interpret mode and
the structured XLA kernel.

Contract (tests/test_pallas_viterbi.py:80-134): analytics exactly equal,
logp within rtol 1e-4 / atol 1e-2 (the struct kernel sums in another
order), decoded paths rescore in f64 to the optimum.  Against the Pallas
pair the twins follow the same float32 steps, so the whole result dict,
the path included, is expected bit-identical."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import advntr_tpu.ops.pallas_viterbi as pv
from advntr_tpu import dna
from advntr_tpu.engine import device_analytics as jda
from advntr_tpu.ops.viterbi_struct import StructDeviceModel
from advntr_tpu_torch.engine import device_analytics as tda
from advntr_tpu_torch.ops import viterbi_fused as vf
from advntr_tpu_torch.ops.struct_model import TorchStructModel
from advntr_tpu_torch.synthetic import locus_model, rescore

# the suite runs test files in parallel worker processes: one torch thread
# each keeps them from oversubscribing the cores
torch.set_num_threads(1)

CASES = [
    (["CAGCAG", "CAGCAG", "CAACAG"], "ACGTTGCA", "TTACGGAT", 3),
    (["CGCGGGGCGGGG"] * 3, "ACGTACTGACGATCGATT", "TTACGGATGCAGTACGTA", 5),
]
READS = [
    "ACGTTGCACAGCAGCAGCAGCAACAGTTACGGAT",
    "TTGCACAGCAGCAGCAGTTACG",
    "CAGCAGCAGCAGCAACAG",
    "ACGTTGCACAGCTGCAGCAGTTACGGAT",
    "ACGTTGCACAGAGCAGCAGTTACGGAT",
    "ACGTTGCACAGGCAGCAGCAGTTACGGAT",
    "ACGTACTGACGATCGATTCGCGGGGCGGGGCGCGGGGCGGGGTTACGGATGCAGTACGTA",
    "GGGGCGGGGCGCGGGGCG",
    "ACGT",
    "TTTTTTTTTTTTTTTTTT",
]
LOGP_TOL = dict(rtol=1e-4, atol=1e-2)


def _models(case):
    art, sm = locus_model(*case)
    return (art, sm, pv.PallasStructModel.from_struct(sm, art),
            TorchStructModel.from_payload(art, sm, "cpu"))


def _meta(art):
    return tuple(jnp.asarray(x) for x in
                 (art.kind, art.region, art.exp_base, art.unit))


def _batch(reads, multiple=8):
    rows = [dna.encode(r) for r in reads]
    batch, lengths = dna.pad_batch(rows, multiple=multiple)
    return rows, batch, lengths


def _random_reads(case, n, seed):
    units, left, right, copies = case
    rng = random.Random(seed)
    reads = []
    for _ in range(n):
        hap = left + units[0] * rng.randint(1, copies + 2) + right
        a = rng.randint(0, max(0, len(hap) - 12))
        reads.append(hap[a:a + rng.randint(10, len(hap) - a)])
    return reads


def _check_against_jax(case, reads, origin32=False):
    art, sm, pm, tm = _models(case)
    rows, batch, lengths = _batch(reads)
    ref_pallas = jda.read_stats_pallas(
        pm.flat(), _meta(art), jnp.asarray(batch), jnp.asarray(lengths),
        return_path=True, interpret=True)
    ref_struct = jda.read_stats_struct(
        StructDeviceModel.from_struct(sm, art).flat(), _meta(art),
        jnp.asarray(batch), jnp.asarray(lengths), sm.suffix_last)
    out = tda.read_stats(tm, torch.as_tensor(batch),
                         torch.as_tensor(lengths), return_path=True,
                         origin32=origin32)
    out = {k: v.numpy() for k, v in out.items()}
    # bit-identical to the Pallas pair
    for k, v in ref_pallas.items():
        np.testing.assert_array_equal(out[k], np.asarray(v), err_msg=k)
    # the struct kernel: the repository's conformance contract
    l1 = np.asarray(ref_struct["logp"])
    np.testing.assert_allclose(out["logp"], l1, **LOGP_TOL)
    keep = l1 > -1e20
    for k in vf.STAT_KEYS:
        np.testing.assert_array_equal(out[k][keep],
                                      np.asarray(ref_struct[k])[keep],
                                      err_msg=k)
    for b, codes in enumerate(rows):
        if keep[b]:
            s = rescore(art, out["path"][b][: len(codes)], codes)
            assert s == pytest.approx(float(l1[b]), rel=1e-4, abs=1e-2)
    return out


@pytest.mark.parametrize("case", CASES)
def test_read_stats_matches_jax_multi_length_batch(case):
    """The Pallas test reads, 54 random multi-length reads and two
    length-1 rows in one 66-read batch."""
    reads = READS + _random_reads(case, 54, seed=99) + ["A", "G"]
    _check_against_jax(case, reads)


def test_read_stats_matches_jax_batch_under_8():
    reads = ["A", "CAGCAGCAG", "G", "ACGTTGCACAGCAGTTACGGAT", "T"]
    out = _check_against_jax(CASES[0], reads)
    assert out["logp"].shape == (5,)


@pytest.mark.parametrize("case", CASES)
def test_walk_statistics_match_path_oracle(case):
    """The in-walk statistics equal the plain analytics_from_path over the
    decoded path (the port's own oracle for B2)."""
    art, sm, pm, tm = _models(case)
    reads = READS + _random_reads(case, 30, seed=17)
    _, batch, lengths = _batch(reads)
    seqs, lens = torch.as_tensor(batch), torch.as_tensor(lengths)
    out = tda.read_stats(tm, seqs, lens, return_path=True)
    meta = tuple(torch.as_tensor(x) for x in
                 (art.kind, art.region, art.exp_base, art.unit))
    oracle = tda.analytics_from_path(meta, out["logp"], out["path"], seqs,
                                     lens)
    for k in vf.STAT_KEYS:
        np.testing.assert_array_equal(out[k].numpy(), oracle[k].numpy(),
                                      err_msg=k)


def test_grouped_read_stats_equals_per_locus():
    art, sm, pm, tm = _models(CASES[0])
    _, batch, lengths = _batch(READS)
    seqs = torch.as_tensor(np.stack([batch, batch[::-1].copy()]))
    lens = torch.as_tensor(np.stack([lengths, lengths[::-1].copy()]))
    grouped = tda.read_stats_grouped([tm, tm], seqs, lens)
    for g in range(2):
        one = tda.read_stats(tm, seqs[g], lens[g])
        for k, v in one.items():
            assert torch.equal(grouped[k][g], v), k


# three loci of one shape (6 bp units, 8 bp flanks, 3 copies)
GROUP_CASES = [
    (["CAGCAG", "CAGCAG", "CAACAG"], "ACGTTGCA", "TTACGGAT", 3),
    (["TTGACC", "TTGACC", "TTGTCC"], "GGATCCAT", "CATGATCG", 3),
    (["ACCGTA", "ACCGTA", "ACCGTA"], "TGCATGCA", "GATTACAG", 3),
]


def _ragged_group():
    """Three same-shape loci, each with its own ragged batch (different
    reads, lengths 1..40), padded to one (G, B, L)."""
    models = [_models(case) for case in GROUP_CASES]
    rows = []
    for g, case in enumerate(GROUP_CASES):
        reads = _random_reads(case, 9 + 2 * g, seed=31 + g) + ["A", "GT"][:g]
        rows.append([dna.encode(r) for r in reads])
    B = max(len(r) for r in rows)
    L = 8 * -(-max(len(c) for r in rows for c in r) // 8)
    seqs = np.zeros((len(rows), B, L), dtype=np.int8)
    lens = np.ones((len(rows), B), dtype=np.int32)   # padding rows: length 1
    for g, r in enumerate(rows):
        for b, codes in enumerate(r):
            seqs[g, b, :len(codes)] = codes
            lens[g, b] = len(codes)
    return models, seqs, lens


def test_grouped_ragged_batches_equal_per_locus_and_jax():
    """G = 3 ragged batches through one grouped call: equal to the
    per-locus results bit for bit, and to the reference's
    read_stats_pallas_grouped in interpret mode under the standing
    contract (statistics exactly, logp rtol 1e-4 / atol 1e-2)."""
    models, seqs, lens = _ragged_group()
    tms = [m[3] for m in models]
    assert len({tm.shape_key() for tm in tms}) == 1
    tseqs, tlens = torch.as_tensor(seqs), torch.as_tensor(lens)
    grouped = tda.read_stats_grouped(tms, tseqs, tlens, return_path=True)
    for g, tm in enumerate(tms):
        one = tda.read_stats(tm, tseqs[g], tlens[g], return_path=True)
        for k, v in one.items():
            assert torch.equal(grouped[k][g], v), (g, k)
    flats = [m[2].flat() for m in models]
    stacked = tuple(jnp.stack([f[i] for f in flats])
                    for i in range(len(flats[0])))
    metas = [_meta(m[0]) for m in models]
    stacked_meta = tuple(jnp.stack([mt[i] for mt in metas])
                         for i in range(4))
    ref = jda.read_stats_pallas_grouped(
        stacked, stacked_meta, jnp.asarray(seqs), jnp.asarray(lens),
        interpret=True)
    np.testing.assert_allclose(grouped["logp"].numpy(),
                               np.asarray(ref["logp"]), **LOGP_TOL)
    for k in vf.STAT_KEYS:
        np.testing.assert_array_equal(grouped[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)


def test_grouped_kernels_twins_equal_per_locus_planes():
    """The grouped forward and walk (looped twins on the CPU) return the
    per-locus planes, paths and statistics with a leading group axis."""
    models, seqs, lens = _ragged_group()
    tms = [m[3] for m in models]
    stack = TorchStructModel.stack(tms)
    tseqs, tlens = torch.as_tensor(seqs), torch.as_tensor(lens)
    fwd = vf.fused_forward_grouped(stack, tseqs, tlens)
    assert fwd[2].shape == (3, seqs.shape[2], seqs.shape[1], 2 * stack.P)
    walk = vf.backward_stats_grouped(stack, tlens, *fwd[1:])
    for g, tm in enumerate(tms):
        one = vf.fused_forward(tm, tseqs[g], tlens[g])
        for got, want in zip(fwd, one):
            assert torch.equal(got[g], want)
        one_walk = vf.backward_stats(tm, tlens[g], *one[1:])
        for got, want in zip(walk, one_walk):
            assert torch.equal(got[g], want)
    with pytest.raises(ValueError, match=r"\(G=3, B, L\)"):
        vf.fused_forward_grouped(stack, tseqs[:2], tlens[:2])


def _ragged_planes(case, origin32=False):
    """Planes of the forward twin for a ragged batch that holds lengths
    0, 1, 2, 3 and L beside the test reads."""
    art, sm, pm, tm = _models(case)
    reads = READS + _random_reads(case, 20, seed=23)
    _, batch, lengths = _batch(reads)
    lengths = lengths.copy()
    lengths[:5] = [0, 1, 2, 3, batch.shape[1]]
    seqs, lens = torch.as_tensor(batch), torch.as_tensor(lengths)
    _, bstate, oMI, oXH = vf.fused_forward_reference(tm, seqs, lens,
                                                     origin32)
    return tm, lens, bstate, oMI, oXH


@pytest.mark.parametrize("window", [1, 8, 32])
@pytest.mark.parametrize("case", CASES)
def test_windowed_walk_equals_walk_on_forward_planes(case, window):
    """The window scheme gives the column-by-column walk's path and
    statistics exactly, on a ragged batch with lengths 0, 1, 2, 3 and L."""
    tm, lens, bstate, oMI, oXH = _ragged_planes(case)
    path_w, stats_w = vf.backward_stats_reference(tm, lens, bstate, oMI, oXH)
    path, stats = vf.backward_stats_windowed_reference(
        tm, lens, bstate, oMI, oXH, window=window)
    assert path.dtype == path_w.dtype and stats.dtype == stats_w.dtype
    assert torch.equal(path, path_w)
    assert torch.equal(stats, stats_w)


def _random_planes(tm, dtype, seed, B=24, L=40):
    """Seeded random planes with every stored value in range: codes of 0,
    sentinels that resolve outside the row, and a diagonal share so that
    windows of every size occur."""
    P, nb = tm.P, tm.nb
    mbit = vf.MBIT32 if dtype == torch.int32 else vf.MBIT16
    rng = np.random.default_rng(seed)
    top = 2 * P + 2 * nb + 3
    oMI = rng.integers(0, top, (L, B, 2 * P))
    diagonal = rng.random((L, B, 2 * P)) < 0.7
    oMI = np.where(diagonal, np.arange(2 * P), oMI)   # code + 1 of s - 1
    match = (rng.random((L, B, 2 * P)) < 0.5) & (np.arange(2 * P) < P)
    oMI = oMI + mbit * match
    oXH = rng.integers(0, top, (L, B, 2 * nb))
    lengths = rng.integers(0, L + 1, B)
    lengths[:5] = [0, 1, 2, 3, L]
    bstate = rng.integers(-1, 2 * P + nb + 2, B)
    bstate[5:12] = rng.integers(1, P, 7)
    return (torch.as_tensor(lengths.astype(np.int32)),
            torch.as_tensor(bstate.astype(np.int32)),
            torch.as_tensor(oMI).to(dtype), torch.as_tensor(oXH).to(dtype))


@pytest.mark.parametrize("window", [1, 8, 32])
@pytest.mark.parametrize("dtype", [torch.int16, torch.int32])
def test_windowed_walk_equals_walk_on_random_planes(dtype, window):
    """Random planes reach what real ones do not: codes of 0 off column 0,
    sentinels past the row, end states outside the model."""
    tm = _models(CASES[0])[3]
    for seed in (3, 4):
        planes = _random_planes(tm, dtype, seed)
        path_w, stats_w = vf.backward_stats_reference(tm, *planes)
        path, stats, n_windows = vf._windowed_walk(tm, *planes, window, True)
        assert torch.equal(path, path_w)
        assert torch.equal(stats, stats_w)
        assert torch.equal(
            n_windows, vf.windows_from_path(path, planes[0], tm.P,
                                             tm.region.shape[0], window))
        if window == 1:
            assert torch.equal(n_windows,
                               planes[0].long().clamp(0, path.shape[1]))


@pytest.mark.parametrize("case", CASES)
def test_windows_counted_from_paths(case):
    """windows_from_path counts the windows the scheme took, and a read
    on the diagonal takes far fewer than it has columns."""
    tm, lens, bstate, oMI, oXH = _ragged_planes(case)
    for window in (8, 32):
        path, _, n_windows = vf._windowed_walk(tm, lens, bstate, oMI, oXH,
                                               window, True)
        assert torch.equal(
            n_windows, vf.windows_from_path(path, lens, tm.P,
                                            tm.region.shape[0], window))
    assert int(n_windows.sum()) < int(lens.sum()) // 2


@pytest.mark.parametrize("grouped", [False, True])
def test_walk_without_path_gives_the_same_statistics(grouped):
    """return_path=False: the same statistics and no path, from the walk,
    the windowed plain version and the whole pipeline."""
    tm, lens, bstate, oMI, oXH = _ragged_planes(CASES[0])
    if grouped:
        stack = TorchStructModel.stack([tm, tm])
        two = lambda x: torch.stack([x, x])
        path, stats = vf.backward_stats_grouped(
            stack, two(lens), two(bstate), two(oMI), two(oXH))
        none, stats2 = vf.backward_stats_grouped(
            stack, two(lens), two(bstate), two(oMI), two(oXH),
            return_path=False)
        assert path.shape == (2,) + tuple(oMI.shape[1::-1])
    else:
        path, stats = vf.backward_stats(tm, lens, bstate, oMI, oXH)
        none, stats2 = vf.backward_stats(tm, lens, bstate, oMI, oXH,
                                         return_path=False)
        none_w, stats_w = vf.backward_stats_windowed_reference(
            tm, lens, bstate, oMI, oXH, return_path=False)
        assert none_w is None and torch.equal(stats_w, stats)
    assert none is None and torch.equal(stats2, stats)


def test_pipeline_asks_the_walk_for_a_path_only_when_needed():
    """read_stats without return_path hands return_path=False down to the
    walk and returns no path; viterbi_batch and return_path=True get the
    paths, a length-1 read's being its end state in every column."""
    art, sm, pm, tm = _models(CASES[0])
    _, batch, lengths = _batch(READS + ["A", "G"])
    seqs, lens = torch.as_tensor(batch), torch.as_tensor(lengths)
    asked = []

    def walk(s, lengths, bstate, oMI, oXH, return_path):
        asked.append(return_path)
        return vf.backward_stats_grouped(s, lengths, bstate, oMI, oXH,
                                         return_path)

    stack = tm.as_stack()
    out = vf.viterbi_stats_grouped(stack, seqs[None], lens[None],
                                   backward=walk)
    with_path = vf.viterbi_stats_grouped(stack, seqs[None], lens[None],
                                         return_path=True, backward=walk)
    assert asked == [False, True]
    assert "path" not in out
    for k, v in out.items():
        assert torch.equal(v, with_path[k]), k
    best, end_state, path = vf.viterbi_batch(tm, seqs, lens)
    assert torch.equal(path, with_path["path"][0])
    ones = lens == 1
    assert int(ones.sum()) == 2
    assert torch.equal(path[ones], end_state[ones, None].expand(-1, path.shape[1]))
    assert vf.viterbi_batch(tm, seqs, lens, return_path=False)[2] is None


def test_one_model_stack_is_made_once(monkeypatch):
    """The per-locus entry points reuse the model's own stack of one: its
    (1,) scalar tensors are built once, not at every call."""
    art, sm, pm, tm = _models(CASES[0])
    stack = tm.as_stack()
    assert tm.as_stack() is stack and stack.models == [tm]
    assert stack.region.data_ptr() == tm.region.data_ptr()
    seen = []
    forward = vf.fused_forward_grouped
    _, batch, lengths = _batch(READS[:3])
    seqs, lens = torch.as_tensor(batch), torch.as_tensor(lengths)
    monkeypatch.setattr(
        vf, "fused_forward_grouped",
        lambda s, *a, **k: (seen.append(s), forward(s, *a, **k))[1])
    vf.fused_forward(tm, seqs, lens)
    assert seen == [stack]


def test_viterbi_batch_contract():
    """viterbi_batch returns the stats pipeline's logp and path, and the
    end state is the path's last valid column (artifact space)."""
    art, sm, pm, tm = _models(CASES[1])
    rows, batch, lengths = _batch(READS)
    seqs, lens = torch.as_tensor(batch), torch.as_tensor(lengths)
    best, end_state, path = vf.viterbi_batch(tm, seqs, lens)
    stats = tda.read_stats(tm, seqs, lens, return_path=True)
    assert torch.equal(best, stats["logp"])
    assert torch.equal(path, stats["path"])
    last = path[torch.arange(len(rows)), lens.long() - 1]
    assert torch.equal(end_state, last)


def test_cuda_tensor_never_reaches_twin(monkeypatch):
    """A non-CPU tensor goes to the kernel wrapper, never to the twin."""
    from advntr_tpu_torch.ops import _kernels
    art, sm, pm, tm = _models(CASES[0])
    calls = []
    monkeypatch.setattr(_kernels, "forward",
                        lambda *a, **k: calls.append("kernel"))
    monkeypatch.setattr(vf, "fused_forward_reference",
                        lambda *a, **k: calls.append("twin"))

    class FakeCuda:
        is_cuda = True
        device = tm.device

        def __init__(self, shape=(1, 8)):
            self.shape = shape

        def dim(self):
            return len(self.shape)

        def __getitem__(self, index):
            assert index is None
            return FakeCuda((1,) + self.shape)

    lengths = torch.ones(1)
    with pytest.raises(TypeError):      # the fake kernel returned nothing
        vf.fused_forward(tm, FakeCuda(), lengths)
    assert calls == ["kernel"]


def test_kernel_wrappers_reject_mismatched_inputs():
    """The wrappers check shapes and devices before any pointer reaches
    the kernels (and before nvcc is needed)."""
    from advntr_tpu_torch.ops import _kernels
    art, sm, pm, tm = _models(CASES[0])
    stack = TorchStructModel.stack([tm])
    seqs = torch.zeros(1, 4, 16, dtype=torch.int8)
    with pytest.raises(ValueError, match="lengths"):
        _kernels.forward(stack, seqs, torch.ones(1, 3, dtype=torch.int32))
    with pytest.raises(ValueError, match=r"\(G=1, B, L\)"):
        _kernels.forward(stack, seqs[0], torch.ones(4, dtype=torch.int32))
    planes = torch.zeros(1, 16, 4, 2 * tm.P, dtype=torch.int16)
    hub = torch.zeros(1, 16, 4, 2 * tm.nb, dtype=torch.int16)
    ones = torch.ones(1, 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="do not fit"):
        _kernels.backward(stack, ones, ones, planes[..., 2:], hub)
    with pytest.raises(ValueError, match="int16 or both int32"):
        _kernels.backward(stack, ones, ones, planes, hub.to(torch.int32))
    with pytest.raises(ValueError, match="G, L, B, width"):
        _kernels.backward(stack, ones, ones, planes[0], hub[0])


@pytest.mark.parametrize("grouped", [False, True])
def test_reads_past_the_column_limit_raise(grouped):
    """One limit holds for the whole-plane pipeline, per locus and
    grouped: reads longer than MAX_COLUMNS are the checkpointed
    traceback's, and the error names it."""
    art, sm, pm, tm = _models(CASES[0])
    L = vf.MAX_COLUMNS + 1
    seqs = torch.zeros(2, L, dtype=torch.int8)
    lengths = torch.full((2,), L, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="viterbi_ckpt"):
        if grouped:
            tda.read_stats_grouped([tm], seqs[None], lengths[None])
        else:
            tda.read_stats(tm, seqs, lengths)


def test_kernel_wrappers_launch_under_their_tensors_device(monkeypatch):
    """C-4: each wrapper of ops/_kernels.py makes its tensors' device the
    current one (``torch.cuda.device``) around its C call and the stream
    lookup, since the kernels' attribute calls and launches act on the
    current device; tensors on two devices raise ValueError before any
    call.  A fake library records the device current at each call (CPU
    tensors here, so the device entered is ``cpu``)."""
    import types

    from advntr_tpu_torch.ops import _kernels
    current = [None]

    class FakeDevice:
        def __init__(self, device):
            self.device = torch.device(device)

        def __enter__(self):
            self.saved, current[0] = current[0], self.device

        def __exit__(self, *exc):
            current[0] = self.saved

    calls = []

    class FakeLib:
        def __getattr__(self, name):
            def call(*args):
                calls.append((name, current[0]))
                return 0
            return call

    monkeypatch.setattr(torch.cuda, "device", FakeDevice)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(
                            multi_processor_count=132))
    monkeypatch.setattr(_kernels, "build",
                        lambda: {src: FakeLib() for src in _kernels.SOURCES})
    monkeypatch.setattr(_kernels, "_stream", lambda dev: calls.append(
        ("stream", current[0])) or 0)
    art, sm, pm, tm = _models(CASES[0])
    stack = TorchStructModel.stack([tm])
    seqs = torch.zeros(1, 4, 16, dtype=torch.int8)
    ones = torch.ones(1, 4, dtype=torch.int32)
    planes = torch.zeros(1, 16, 4, 2 * tm.P, dtype=torch.int16)
    hub = torch.zeros(1, 16, 4, 2 * tm.nb, dtype=torch.int16)
    reads = torch.zeros(1, 4, 64, dtype=torch.int8)
    probes = torch.zeros(1, 16, dtype=torch.int8)
    _kernels.forward(stack, seqs, ones)
    _kernels.forward(stack, seqs, ones, wide=True)
    _, _, _, _, state = _kernels.forward_segment(stack, seqs, ones, t0=0)
    _kernels.forward_segment(stack, seqs, ones, state=state, t0=16)
    _kernels.backward(stack, ones, ones, planes, hub)
    _kernels.backward_segment(stack, ones, ones, planes, hub, 16, ones)
    _kernels.local_align_passes(reads, ones[0], probes, [8], [0])
    cpu = torch.device("cpu")
    names = [name for name, _ in calls if name != "stream"]
    assert names == ["advntr_viterbi_forward"] * 4 + \
        ["advntr_viterbi_backward"] * 2 + ["advntr_local_align"]
    assert calls and all(dev == cpu for _, dev in calls), calls
    assert current[0] is None
    meta = torch.device("meta")
    calls.clear()
    with pytest.raises(ValueError, match="2 devices"):
        _kernels.forward(stack, seqs.to(meta), ones)
    with pytest.raises(ValueError, match="2 devices"):
        _kernels.forward_segment(stack, seqs, ones,
                                 state=tuple(x.to(meta) for x in state),
                                 t0=16)
    with pytest.raises(ValueError, match="2 devices"):
        _kernels.backward(stack, ones, ones, planes.to(meta), hub.to(meta))
    with pytest.raises(ValueError, match="2 devices"):
        _kernels.local_align_passes(reads, ones[0], probes.to(meta), [8],
                                    [0])
    assert calls == []
