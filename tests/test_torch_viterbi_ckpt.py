"""The port's checkpointed traceback (plain PyTorch twins on the CPU):
bit-identical to its whole-plane path for every segment length, and held
to the JAX reference's checkpointed struct kernel under the repository's
conformance contract (tests/test_pallas_viterbi.py:80-134): statistics
exactly equal, logp within rtol 1e-4 / atol 1e-2 (the struct kernel sums
in another order), decoded paths rescoring in float64 to viterbi_numpy's
optimum within rel 1e-6 / abs 1e-6.  Counterparts of the five tests of
tests/test_viterbi_ckpt.py."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from advntr_tpu import dna
from advntr_tpu.engine import device_analytics as jda
from advntr_tpu.ops.viterbi import viterbi_numpy
from advntr_tpu.ops.viterbi_struct import StructDeviceModel
from advntr_tpu_torch.engine import device_analytics as tda
from advntr_tpu_torch.engine import finder as tfinder
from advntr_tpu_torch.engine import locus_model as tlm
from advntr_tpu_torch.ops import viterbi_ckpt as vc
from advntr_tpu_torch.ops import viterbi_fused as vf
from advntr_tpu_torch.ops.struct_model import TorchStructModel
from advntr_tpu_torch.synthetic import locus_model, rand_seq, rescore

# the suite runs test files in parallel worker processes: one torch thread
# each keeps them from oversubscribing the cores
torch.set_num_threads(1)

CASE = (["CAGCAG", "CAGCAG", "CAACAG"], "ACGTTGCA", "TTACGGAT", 3)
READS = [
    "ACGTTGCACAGCAGCAGCAGCAACAGTTACGGAT",
    "TTGCACAGCAGCAGCAGTTACG",
    "CAGCAGCAGCAGCAACAG",
    "ACGTTGCACAGCTGCAGCAGTTACGGAT",
    "ACGT",
    "A",                       # lengths == 1 edge case
    "TTTTTTTTTTTTTTTTTT",
]
LOGP_TOL = dict(rtol=1e-4, atol=1e-2)


def _models(case, **kw):
    art, sm = locus_model(*case, **kw)
    return art, sm, TorchStructModel.from_payload(art, sm, "cpu")


def _batch(reads, multiple=8, pad_to=None):
    rows = [dna.encode(r) for r in reads]
    batch, lengths = dna.pad_batch(rows, pad_to=pad_to, multiple=multiple)
    return rows, batch, lengths


def _jax_ckpt(art, sm, batch, lengths, segment, return_path=True):
    meta = tuple(jnp.asarray(x) for x in
                 (art.kind, art.region, art.exp_base, art.unit))
    out = jda.read_stats_struct_ckpt(
        StructDeviceModel.from_struct(sm, art).flat(), meta,
        jnp.asarray(batch), jnp.asarray(lengths), sm.suffix_last,
        return_path=return_path, segment=segment)
    return {k: np.asarray(v) for k, v in out.items()}


def _assert_contract(out, ref, art, rows):
    """The port's dict against the reference's under the contract."""
    np.testing.assert_allclose(out["logp"], ref["logp"], **LOGP_TOL)
    keep = ref["logp"] > -1e20
    for k in vf.STAT_KEYS:
        np.testing.assert_array_equal(out[k][keep], ref[k][keep], err_msg=k)
    for b, codes in enumerate(rows):
        if keep[b]:
            best, _ = viterbi_numpy(art, codes)
            s = rescore(art, out["path"][b][: len(codes)], codes)
            assert s == pytest.approx(best, rel=1e-6, abs=1e-6)


@pytest.mark.parametrize("segment", [3, 64])
def test_ckpt_matches_plain_struct(segment):
    """Segments of 3 and of 64 columns (the latter one segment) give the
    whole-plane path's score, end state, path and statistics bit for bit,
    and the reference's checkpointed kernel's under the contract."""
    art, sm, tm = _models(CASE)
    rows, batch, lengths = _batch(READS)
    seqs, lens = torch.as_tensor(batch), torch.as_tensor(lengths)
    best0, end0, path0 = vf.viterbi_batch(tm, seqs, lens)
    best1, end1, path1 = vc.viterbi_checkpointed(tm, seqs, lens,
                                                 segment=segment)
    assert torch.equal(best0, best1)
    assert torch.equal(end0, end1)
    assert torch.equal(path0, path1)
    whole = tda.read_stats(tm, seqs, lens, return_path=True)
    out = tda.read_stats_ckpt(tm, seqs, lens, return_path=True,
                              segment=segment)
    assert set(out) == set(whole)
    for k, v in whole.items():
        assert torch.equal(out[k], v), k
    ref = _jax_ckpt(art, sm, batch, lengths, segment)
    _assert_contract({k: v.numpy() for k, v in out.items()}, ref, art, rows)


def _ragged_long_batch():
    """Reads of length 1, reads that end in the middle of a segment, reads
    that end segments before the batch does, and padding columns."""
    case = (["CGCGGGGCGGGG"] * 3, rand_seq(3, 40), rand_seq(4, 40), 9)
    units, left, right, copies = case
    rng = random.Random(21)
    hap = left + units[0] * 8 + right
    reads = [hap, hap[:1], hap[5:70], "G", hap[10:10 + 64], hap[3:3 + 65],
             hap[:128], hap[20:151], "".join(rng.choice("ACGT")
                                             for _ in range(90))]
    return case, reads


@pytest.mark.parametrize("segment", [1, 3, 64, 512])
def test_ckpt_segments_equal_whole_planes_on_ragged_batch(segment):
    case, reads = _ragged_long_batch()
    art, sm, tm = _models(case)
    _, batch, lengths = _batch(reads, multiple=64)
    assert batch.shape[1] > max(len(r) for r in reads)    # padding columns
    seqs, lens = torch.as_tensor(batch), torch.as_tensor(lengths)
    whole = tda.read_stats(tm, seqs, lens, return_path=True)
    out = tda.read_stats_ckpt(tm, seqs, lens, return_path=True,
                              segment=segment)
    for k, v in whole.items():
        assert torch.equal(out[k], v), k
    no_path = tda.read_stats_ckpt(tm, seqs, lens, segment=segment)
    assert "path" not in no_path
    best, bstate, none = vc.viterbi_checkpointed_grouped(
        tm.as_stack(), seqs[None], lens[None], segment, return_path=False)
    assert none is None and torch.equal(best[0], whole["logp"])


@pytest.mark.parametrize("origin32", [False, True])
def test_forward_segments_carry_the_twin_state(origin32):
    """Planes, exit state, score and end state of the forward twin run
    segment by segment equal the whole read's, bit for bit."""
    case, reads = _ragged_long_batch()
    art, sm, tm = _models(case)
    _, batch, lengths = _batch(reads, multiple=64)
    seqs, lens = torch.as_tensor(batch), torch.as_tensor(lengths)
    best, bstate, oMI, oXH = vf.fused_forward_reference(tm, seqs, lens,
                                                        origin32)
    whole_state, _, _ = vf.fused_forward_segment_reference(
        tm, seqs, lens, origin32, planes=False)
    for K in (5, 64):
        state = None
        for c0 in range(0, seqs.shape[1], K):
            state, sMI, sXH = vf.fused_forward_segment_reference(
                tm, seqs[:, c0:c0 + K], lens, origin32, state, c0)
            assert torch.equal(sMI, oMI[c0:c0 + K])
            assert torch.equal(sXH, oXH[c0:c0 + K])
        assert torch.equal(state[0], whole_state[0])
        assert torch.equal(state[1], whole_state[1])
        b, e = vf.forward_state_best(tm, state)
        assert torch.equal(b, best) and torch.equal(e, bstate)


@pytest.mark.parametrize("window", [1, 8, 32])
def test_walk_segments_equal_whole_walk(window):
    """The column walk and the window scheme over column ranges, each
    from the state the range above left, give the whole walk's path."""
    case, reads = _ragged_long_batch()
    art, sm, tm = _models(case)
    _, batch, lengths = _batch(reads, multiple=64)
    seqs, lens = torch.as_tensor(batch), torch.as_tensor(lengths)
    _, bstate, oMI, oXH = vf.fused_forward_reference(tm, seqs, lens)
    path_w, _ = vf.backward_stats_reference(tm, lens, bstate, oMI, oXH)
    L = seqs.shape[1]
    for K in (3, 50):
        cur = cur_w = bstate
        path = torch.empty_like(path_w)
        path_win = torch.empty_like(path_w)
        for c0 in reversed(range(0, L, K)):
            planes = (oMI[c0:c0 + K], oXH[c0:c0 + K])
            path[:, c0:c0 + K], _, cur = vf.backward_walk_segment_reference(
                tm, lens, bstate, *planes, c0, cur)
            path_win[:, c0:c0 + K], _, _, cur_w = vf.windowed_walk_segment(
                tm, lens, bstate, *planes, window, True, c0, cur_w)
            assert torch.equal(cur, cur_w)
        assert torch.equal(path, path_w)
        assert torch.equal(path_win, path_w)


def test_ckpt_matches_f64_oracle():
    art, sm, tm = _models(CASE)
    reads = ["ACGTTGCACAGCAGCAGCAGCAACAGTTACGGAT",
             "ACGTTGCACAGCTGCAGCAGTTACGGAT"]
    rows, batch, lengths = _batch(reads)
    logp, _, path = vc.viterbi_checkpointed(
        tm, torch.as_tensor(batch), torch.as_tensor(lengths), segment=5)
    logp, path = logp.numpy(), path.numpy()
    for b, codes in enumerate(rows):
        ref_logp, _ = viterbi_numpy(art, codes)
        assert logp[b] == pytest.approx(ref_logp, rel=1e-4, abs=1e-2)
        # the decoded path rescored in f64 must reach the optimum
        score = rescore(art, path[b][: len(codes)], codes)
        assert score == pytest.approx(ref_logp, rel=1e-6, abs=1e-6)


def test_ckpt_pacbio_scale():
    """A 30-base motif x 16 copies between 150-base flanks at error rate
    0.3 against a noisy multi-hundred-column read: the shape class of the
    long-read path at test size, against the reference's checkpointed
    kernel and against the port's own whole planes."""
    pattern = rand_seq(5, 30)
    left, right = rand_seq(6, 150), rand_seq(7, 150)
    art, sm, tm = _models(([pattern] * 3, left, right, 16), err=0.3)
    rng = random.Random(11)
    hap = left + pattern * 13 + right

    def mutate(s):
        out = []
        for ch in s:
            r = rng.random()
            if r < 0.03:
                continue                      # deletion
            if r < 0.06:
                out.append(rng.choice("ACGT"))  # substitution
            else:
                out.append(ch)
            if rng.random() < 0.03:
                out.append(rng.choice("ACGT"))  # insertion
        return "".join(out)

    reads = [mutate(hap), mutate(hap[100:500])]
    rows, batch, lengths = _batch(reads, multiple=64)
    assert batch.shape[1] >= 384
    seqs, lens = torch.as_tensor(batch), torch.as_tensor(lengths)
    out = tda.read_stats_ckpt(tm, seqs, lens, return_path=True, segment=128)
    whole = tda.read_stats(tm, seqs, lens, return_path=True)
    for k, v in whole.items():
        assert torch.equal(out[k], v), k
    ref = _jax_ckpt(art, sm, batch, lengths, 128)
    out = {k: v.numpy() for k, v in out.items()}
    np.testing.assert_allclose(out["logp"], ref["logp"], **LOGP_TOL)
    for k in vf.STAT_KEYS:
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
    for b, codes in enumerate(rows):
        s = rescore(art, out["path"][b][: len(codes)], codes)
        s_ref = rescore(art, ref["path"][b][: len(codes)], codes)
        assert s == pytest.approx(s_ref, rel=1e-6, abs=1e-6)


def test_run_device_routes_long_reads(monkeypatch):
    """finder.run_device sends batches longer than CKPT_TRACEBACK_L to the
    checkpointed path, with CKPT_SEGMENT columns a segment; both are
    constants of the locus model's module."""
    monkeypatch.setattr(tlm, "CKPT_TRACEBACK_L", 64)
    monkeypatch.setattr(tlm, "CKPT_SEGMENT", 16)
    art, sm, tm = _models((["CAGCAG"] * 3, "ACGTTGCA", "TTACGGAT", 3))
    lm = tlm.LocusModel(model=tm, n_pad=art.n_states)
    read = "ACGTTGCA" + "CAGCAG" * 3 + "TTACGGAT"
    _, batch, lengths = _batch([read], multiple=128, pad_to=128)

    class _Finder:
        device = torch.device("cpu")
        run_device = tfinder.VNTRFinder.run_device

    called = {}
    orig = tda.read_stats_ckpt

    def spy(*a, **k):
        called.update(k)
        return orig(*a, **k)

    monkeypatch.setattr(tda, "read_stats_ckpt", spy)
    stats = _Finder().run_device(lm, batch, lengths)
    assert called == {"segment": 16}
    plain = tda.read_stats(tm, torch.as_tensor(batch),
                           torch.as_tensor(lengths))
    for key in ("logp", "repeats", "n_matches", "repeat_bp"):
        np.testing.assert_array_equal(stats[key], plain[key].numpy())
    # a batch at the limit keeps whole planes
    called.clear()
    _Finder().run_device(lm, batch[:, :64], np.minimum(lengths, 64))
    assert called == {}


class _LargestTensor(TorchDispatchMode):
    """Records the largest tensor any operation returns."""

    def __init__(self):
        super().__init__()
        self.worst = (0, None, None)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor) and t.numel() > self.worst[0]:
                self.worst = (t.numel(), tuple(t.shape), str(func))
        return out


def test_ckpt_no_full_read_planes():
    """Memory-shape regression: the checkpointed path must never allocate
    a tensor the size of a full-read (L, B, P) plane.  Every tensor any of
    its operations returns stays below (L - 1) * B * P elements, and at
    the size of one segment's (K, B, 2P) plane; the whole-plane path is
    seen to pass the bound by the same means."""
    art, sm, tm = _models((["CAGCAG", "CAGCAG", "CAACAG"], "ACGTTGCA",
                           "TTACGGAT", 6))
    B, L, segment = 4, 512, 64
    rng = random.Random(11)
    reads = ["".join(rng.choice("ACGT") for _ in range(L)) for _ in range(B)]
    _, batch, lengths = _batch(reads, pad_to=L)
    seqs, lens = torch.as_tensor(batch), torch.as_tensor(lengths)
    budget = (L - 1) * B * tm.P
    with _LargestTensor() as seen:
        tda.read_stats_ckpt(tm, seqs, lens, segment=segment)
    assert seen.worst[0] < budget, seen.worst
    assert seen.worst[0] <= segment * B * 2 * tm.P, seen.worst
    with _LargestTensor() as whole:
        tda.read_stats(tm, seqs, lens)
    assert whole.worst[0] >= L * B * 2 * tm.P


def test_run_device_routes_long_reads_struct(monkeypatch):
    """Under ``ADVNTR_TPU_KERNEL=struct`` run_device decodes with the
    structured path, and a batch longer than CKPT_TRACEBACK_L through its
    checkpointed traceback (finder.py:772-781), segments of CKPT_SEGMENT
    columns, giving the whole-read path's statistics; no B1/B2 path is
    taken."""
    monkeypatch.setenv("ADVNTR_TPU_KERNEL", "struct")
    monkeypatch.setattr(tlm, "CKPT_TRACEBACK_L", 64)
    monkeypatch.setattr(tlm, "CKPT_SEGMENT", 16)
    cache = tlm.LocusModelCache("cpu")
    art, sm, _ = _models((["CAGCAG"] * 3, "ACGTTGCA", "TTACGGAT", 3))
    lm = cache.build(art, sm)
    assert lm.kernel == "struct" and lm.struct is None
    read = "ACGTTGCA" + "CAGCAG" * 3 + "TTACGGAT"
    _, batch, lengths = _batch([read, read[:50], "A"], multiple=128,
                               pad_to=128)

    class _Finder:
        device = torch.device("cpu")
        run_device = tfinder.VNTRFinder.run_device

    called = []
    orig = tda.read_stats_struct_ckpt

    def spy(*a, **k):
        called.append(k)
        return orig(*a, **k)

    monkeypatch.setattr(tda, "read_stats_struct_ckpt", spy)
    monkeypatch.setattr(tda, "read_stats_ckpt", None)
    monkeypatch.setattr(tda, "read_stats", None)
    stats = _Finder().run_device(lm, batch, lengths, return_paths=True)
    assert called == [{"segment": 16, "return_path": True}]
    whole = tda.read_stats_struct(
        lm.struct_model(), lm.model.art_meta, torch.as_tensor(batch),
        torch.as_tensor(lengths), sm.suffix_last, return_path=True)
    assert set(stats) == set(whole)
    for key in whole:
        np.testing.assert_array_equal(stats[key], whole[key].numpy())
    called.clear()
    _Finder().run_device(lm, batch[:, :64], np.minimum(lengths, 64))
    assert called == []


def test_struct_ckpt_no_full_read_planes():
    """The structured checkpointed traceback allocates no tensor the size
    of the whole read's value planes: every tensor its operations return
    stays within one segment's (K, B, 2P + nb) planes, where the
    whole-read path's planes are (L - 1, B, 2P + nb)."""
    from advntr_tpu_torch.ops.viterbi_struct import StructDeviceModel
    art, sm, _ = _models((["CAGCAG", "CAGCAG", "CAACAG"], "ACGTTGCA",
                          "TTACGGAT", 6))
    m = StructDeviceModel.from_struct(sm, art, "cpu")
    meta = tuple(torch.as_tensor(np.asarray(x)) for x in
                 (art.kind, art.region, art.exp_base, art.unit))
    B, L, segment = 4, 512, 64
    S = 2 * sm.P + sm.nb
    rng = random.Random(12)
    reads = ["".join(rng.choice("ACGT") for _ in range(L)) for _ in range(B)]
    _, batch, lengths = _batch(reads, pad_to=L)
    seqs, lens = torch.as_tensor(batch), torch.as_tensor(lengths)
    with _LargestTensor() as seen:
        tda.read_stats_struct_ckpt(m, meta, seqs, lens, sm.suffix_last,
                                   segment=segment)
    assert seen.worst[0] <= max(segment * B * S, S * S), seen.worst
    with _LargestTensor() as whole:
        tda.read_stats_struct(m, meta, seqs, lens, sm.suffix_last)
    assert whole.worst[0] >= (L - 1) * B * S
