"""The port's structured decoder (ops/viterbi_struct.py, plain PyTorch on
the CPU) against the reference's (advntr_tpu/ops/viterbi_struct.py, XLA on
the CPU) on the same seeded inputs: the models of
tests/test_viterbi_struct.py, unpadded and padded as the engine pads them,
and a suffix index of -1 (``jnp.take`` wraps it to the last column) and
one past the end (NaN).

Every value is a max over the reference's float32 additions, so logp is
held bit-equal (NaN where the reference's is NaN), and end states, paths
and analytics exactly equal; the grouped and checkpointed forms equal the
whole-read form, and the reference's own checkpointed path."""

import dataclasses
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advntr_tpu.engine import device_analytics as jda
from advntr_tpu.ops.viterbi_ckpt import viterbi_struct_checkpointed as jckpt
from advntr_tpu.ops.viterbi_struct import StructDeviceModel as JStruct
from advntr_tpu.ops.viterbi_struct import viterbi_struct_batch as jbatch
from advntr_tpu_torch import dna
from advntr_tpu_torch.engine import device_analytics as tda
from advntr_tpu_torch.models.compiler import compile_graph
from advntr_tpu_torch.models.graph import build_read_matcher
from advntr_tpu_torch.models.profile import profile_for_repeats
from advntr_tpu_torch.models.struct_compiler import build_structured
from advntr_tpu_torch.ops.viterbi_ckpt import viterbi_struct_checkpointed
from advntr_tpu_torch.ops.viterbi_struct import (StructDeviceModel,
                                                 viterbi_struct_batch)
from advntr_tpu_torch.synthetic import locus_model

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
    "A",                       # a read of length 1
    "ACGTTGCANNGCAGCAGTTACG",  # N is code 4: NaN emissions on both sides
]


def _unpadded(case):
    units, left, right, copies = case
    trans, emis = profile_for_repeats(units, 0.05)
    g = build_read_matcher(left, right, trans, emis, copies, 0.05)
    art = compile_graph(g)
    return art, build_structured(g, art)


def _model(name):
    """(art, sm, suffix index handed to both decoders) of a test model."""
    kind, i = name.split(":")
    case = CASES[int(i)]
    art, sm = _unpadded(case) if kind == "unpadded" else locus_model(*case)
    suffix = {"wrap": -1, "past": sm.P}.get(kind, sm.suffix_last)
    if kind in ("wrap", "past"):
        sm = dataclasses.replace(sm, suffix_last=suffix)
    return art, sm, suffix


MODELS = ["unpadded:0", "unpadded:1", "padded:0", "padded:1", "wrap:0",
          "past:1"]


def _batch(reads=READS, multiple=8):
    rows = [dna.encode(r) for r in reads]
    batch, lengths = dna.pad_batch(rows, multiple=multiple)
    return rows, batch, lengths


def _equal(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("name", MODELS)
def test_struct_batch_equals_reference(name):
    art, sm, suffix = _model(name)
    _, batch, lengths = _batch()
    want = jbatch(JStruct.from_struct(sm, art).flat(), jnp.asarray(batch),
                  jnp.asarray(lengths), suffix_last=suffix)
    got = viterbi_struct_batch(StructDeviceModel.from_struct(sm, art, "cpu"),
                               torch.as_tensor(batch),
                               torch.as_tensor(lengths), suffix)
    for g, w in zip(got, want):
        _equal(g, w)
    logp = np.asarray(want[0])
    assert np.isnan(logp[-1])          # the N read
    assert np.isfinite(logp[-2])       # "A": column 0 alone, no silent layer
    if name.startswith("past"):
        assert np.isnan(logp[:-2]).all()   # every suffix exit reads NaN
    else:
        assert np.isfinite(logp[:-1]).all()
    no_path = viterbi_struct_batch(
        StructDeviceModel.from_struct(sm, art, "cpu"), torch.as_tensor(batch),
        torch.as_tensor(lengths), suffix, return_path=False)
    _equal(no_path[0], got[0])
    assert no_path[1:] == (None, None)


@pytest.mark.parametrize("name", ["unpadded:1", "padded:0"])
def test_from_arrays_equals_from_struct(name):
    art, sm, _ = _model(name)
    own = StructDeviceModel.from_struct(sm, art, "cpu")
    carried = StructDeviceModel.from_arrays(
        [np.asarray(x) for x in JStruct.from_struct(sm, art).flat()], "cpu")
    for f in dataclasses.fields(StructDeviceModel):
        a, b = getattr(own, f.name), getattr(carried, f.name)
        assert a.dtype == b.dtype and torch.equal(a, b), f.name


def _group():
    """Three same-shape padded loci (6 bp units, 8 bp flanks), each with
    its own ragged batch of seeded reads, as one (G, B, L) batch."""
    cases = [CASES[0],
             (["TTGACC", "TTGACC", "TTGTCC"], "GGATCCAT", "CATGATCG", 3),
             (["ACCGTA", "ACCGTA", "ACCGTA"], "TGCATGCA", "GATTACAG", 3)]
    built = [locus_model(*case) for case in cases]
    B = 9
    seqs, lens = [], []
    for g, (units, left, right, copies) in enumerate(cases):
        rng = random.Random(70 + g)
        reads = ["A"]
        while len(reads) < B:
            hap = left + units[0] * rng.randint(1, copies + 2) + right
            a = rng.randint(0, len(hap) - 12)
            reads.append(hap[a:a + rng.randint(10, len(hap) - a)])
        _, b, ln = _batch(reads)
        seqs.append(np.pad(b, ((0, 0), (0, 48 - b.shape[1]))))
        lens.append(ln)
    return built, np.stack(seqs), np.stack(lens)


def test_grouped_equals_each_locus_alone():
    built, seqs, lens = _group()
    models = [StructDeviceModel.from_struct(sm, art, "cpu")
              for art, sm in built]
    sls = torch.tensor([sm.suffix_last for _, sm in built])
    got = viterbi_struct_batch(StructDeviceModel.stack(models),
                               torch.as_tensor(seqs), torch.as_tensor(lens),
                               sls)
    ckpt = viterbi_struct_checkpointed(
        StructDeviceModel.stack(models), torch.as_tensor(seqs),
        torch.as_tensor(lens), sls, segment=5)
    for g, (m, (art, sm)) in enumerate(zip(models, built)):
        alone = viterbi_struct_batch(m, torch.as_tensor(seqs[g]),
                                     torch.as_tensor(lens[g]),
                                     sm.suffix_last)
        for a, b, c in zip(got, alone, ckpt):
            assert torch.equal(a[g], b) and torch.equal(c[g], b)


@pytest.mark.parametrize("segment", [7, 16, 512])
def test_checkpointed_equals_whole_read_and_reference(segment):
    art, sm, _ = _model("padded:1")
    rng = random.Random(5)
    units, left, right, copies = CASES[1]
    reads = [left + units[0] * rng.randint(1, 7) + right
             for _ in range(5)] + READS
    _, batch, lengths = _batch(reads)
    m = StructDeviceModel.from_struct(sm, art, "cpu")
    args = (torch.as_tensor(batch), torch.as_tensor(lengths), sm.suffix_last)
    whole = viterbi_struct_batch(m, *args)
    got = viterbi_struct_checkpointed(m, *args, segment=segment)
    want = jckpt(JStruct.from_struct(sm, art).flat(), jnp.asarray(batch),
                 jnp.asarray(lengths), sm.suffix_last, segment=segment)
    for g, w, r in zip(got, whole, want):
        _equal(g, w)
        _equal(g, r)
    best, none1, none2 = viterbi_struct_checkpointed(
        m, *args, segment=segment, return_path=False)
    _equal(best, whole[0])
    assert none1 is None and none2 is None


def _meta(art):
    return tuple(np.asarray(x) for x in
                 (art.kind, art.region, art.exp_base, art.unit))


def _assert_dicts_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        _equal(got[k], want[k])


def test_read_stats_struct_dicts_equal_reference():
    art, sm, _ = _model("padded:0")
    rows, batch, lengths = _batch(READS[:-1])
    jm = JStruct.from_struct(sm, art).flat()
    meta = _meta(art)
    jmeta = tuple(jnp.asarray(x) for x in meta)
    tmeta = tuple(torch.as_tensor(x) for x in meta)
    m = StructDeviceModel.from_struct(sm, art, "cpu")
    tb, tl = torch.as_tensor(batch), torch.as_tensor(lengths)
    jb, jl = jnp.asarray(batch), jnp.asarray(lengths)
    _assert_dicts_equal(
        tda.read_stats_struct(m, tmeta, tb, tl, sm.suffix_last,
                              return_path=True),
        jda.read_stats_struct(jm, jmeta, jb, jl, sm.suffix_last,
                              return_path=True))
    _assert_dicts_equal(
        tda.read_stats_struct_ckpt(m, tmeta, tb, tl, sm.suffix_last,
                                   segment=9),
        jda.read_stats_struct_ckpt(jm, jmeta, jb, jl, sm.suffix_last,
                                   segment=9))


def test_read_stats_struct_grouped_equals_reference():
    built, seqs, lens = _group()
    metas = [_meta(art) for art, _ in built]
    sls = np.array([sm.suffix_last for _, sm in built], dtype=np.int32)
    n = max(m[0].shape[0] for m in metas)
    fills = (3, 3, -1, -1)
    jmeta = tuple(jnp.stack([jnp.asarray(np.pad(m[i], (0, n - len(m[i])),
                                                constant_values=fills[i]))
                             for m in metas]) for i in range(4))
    flats = [JStruct.from_struct(sm, art).flat() for art, sm in built]
    jstack = tuple(jnp.stack([f[i] for f in flats])
                   for i in range(len(flats[0])))
    want = jda.read_stats_struct_grouped(jstack, jmeta, jnp.asarray(seqs),
                                         jnp.asarray(lens),
                                         jnp.asarray(sls), return_path=True)
    models = [StructDeviceModel.from_struct(sm, art, "cpu")
              for art, sm in built]
    got = tda.read_stats_struct_grouped(
        StructDeviceModel.stack(models),
        tda.stack_meta([tuple(torch.as_tensor(x) for x in m) for m in metas]),
        torch.as_tensor(seqs), torch.as_tensor(lens), torch.as_tensor(sls),
        return_path=True)
    _assert_dicts_equal(got, want)
