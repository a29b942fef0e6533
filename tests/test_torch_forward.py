"""The port's dense batched decoders (ops/viterbi.py: ``forward_batch``,
``viterbi_batch``) against the JAX package's on the same seeded reads, on
the CPU, after tests/test_forward.py:21.

Tolerances: the forward log-likelihood within rtol 1e-5 / atol 1e-3 (both
sum in float32, in another order); the Viterbi best within rtol 1e-4 /
atol 1e-2 (the repo's logp contract); the decoded paths equal wherever
the optimum is unique, and where they differ both rescore in float64 to
the same value (a tie)."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advntr_tpu.ops import viterbi as jviterbi
from advntr_tpu_torch import dna
from advntr_tpu_torch.engine.simulate import mutate
from advntr_tpu_torch.models.compiler import (compile_graph, compile_graph_sum,
                                              forward_full_graph)
from advntr_tpu_torch.models.graph import build_read_matcher
from advntr_tpu_torch.models.profile import profile_for_repeats
from advntr_tpu_torch.ops import viterbi
from advntr_tpu_torch.synthetic import rand_seq, rescore

# the suite runs test files in parallel worker processes: one torch thread
# each keeps them from oversubscribing the cores
torch.set_num_threads(1)

READS = [
    "ACGTTGCACAGCAGCAGCAGCAACAGTTACGGAT",
    "TTGCACAGCAGCAGCAGTTACG",
    "CAGCAGCAGCAGCAACAG",
    "ACGTTGCACAGCTGCAGCAGTTACGGAT",
    "A",
]

SMALL = (["CAGCAG", "CAGCAG", "CAACAG"], "ACGTTGCA", "TTACGGAT", 3)
WIDER = (["CGCGGGGCGGGG"] * 3, rand_seq(3, 40), rand_seq(4, 40), 6)


def _graph(units, left, right, copies):
    trans, emis = profile_for_repeats(list(units), 0.05)
    return build_read_matcher(left, right, trans, emis, copies, 0.05)


def _reads(case, n, seed):
    """``n`` seeded reads of the case's haplotypes, 2% substitutions, with
    the fixed READS for the small model."""
    if case is SMALL:
        return READS
    units, left, right, copies = case
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        hap = left + units[0] * rng.randint(1, copies) + right
        a = rng.randint(0, len(hap) // 2)
        out.append(mutate(hap[a:a + rng.randint(1, 70)], 0.02, rng))
    return out


def _batch(reads):
    rows = [dna.encode(r) for r in reads]
    return (rows,) + dna.pad_batch(rows, multiple=8)


def _clean(x):
    return np.where(np.isfinite(x), x, -1e30).astype(np.float32)


@pytest.mark.parametrize("case", [SMALL, WIDER], ids=["small", "wider"])
def test_forward_batch_equals_jax(case):
    g = _graph(*case)
    tables = [_clean(x) for x in compile_graph_sum(g)]
    rows, batch, lengths = _batch(_reads(case, 12, seed=1))
    want = np.asarray(jviterbi.forward_batch(
        *(jnp.asarray(t) for t in tables), jnp.asarray(batch),
        jnp.asarray(lengths)))
    got = viterbi.forward_batch(
        *(torch.as_tensor(t) for t in tables), torch.as_tensor(batch),
        torch.as_tensor(lengths)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)
    if case is SMALL:
        # and the float64 full-graph oracle, as test_forward.py holds JAX
        for b, codes in enumerate(rows):
            assert got[b] == pytest.approx(forward_full_graph(g, codes),
                                           rel=1e-4, abs=1e-2)


@pytest.mark.parametrize("case", [SMALL, WIDER], ids=["small", "wider"])
def test_viterbi_batch_equals_jax(case):
    art = compile_graph(_graph(*case))
    rows, batch, lengths = _batch(_reads(case, 24, seed=2))
    want_best, want_end, want_path = (np.asarray(x) for x in
                                      jviterbi.viterbi_batch(
        *jviterbi.prepare_model_tensors(art), jnp.asarray(batch),
        jnp.asarray(lengths)))
    best, end, path = viterbi.viterbi_batch(
        *viterbi.prepare_model_tensors(art, "cpu"), torch.as_tensor(batch),
        torch.as_tensor(lengths))
    best, end, path = best.numpy(), end.numpy(), path.numpy()
    np.testing.assert_allclose(best, want_best, rtol=1e-4, atol=1e-2)
    assert path.shape == want_path.shape and path.dtype == np.int32
    same = 0
    for b, codes in enumerate(rows):
        mine, theirs = path[b][:len(codes)], want_path[b][:len(codes)]
        if np.array_equal(mine, theirs):
            same += 1
            assert end[b] == want_end[b]
            continue
        # a tie: both paths reach the same optimum
        assert rescore(art, mine, codes) == pytest.approx(
            rescore(art, theirs, codes), rel=1e-9, abs=1e-9), b
        assert rescore(art, mine, codes) == pytest.approx(
            float(best[b]), rel=1e-4, abs=1e-2)
    assert same >= len(rows) - 2, (same, len(rows))


def test_viterbi_batch_without_path_and_prepare_device():
    art = compile_graph(_graph(*SMALL))
    tables = viterbi.prepare_model_tensors(art, torch.device("cpu"))
    assert all(t.dtype == torch.float32 and t.device.type == "cpu"
               for t in tables)
    assert float(tables[0].min()) == pytest.approx(-1e30)
    _, batch, lengths = _batch(READS)
    best, end, path = viterbi.viterbi_batch(
        *tables, torch.as_tensor(batch), torch.as_tensor(lengths),
        return_path=False)
    assert end is None and path is None
    full, _, _ = viterbi.viterbi_batch(*tables, torch.as_tensor(batch),
                                       torch.as_tensor(lengths))
    assert torch.equal(best, full)
