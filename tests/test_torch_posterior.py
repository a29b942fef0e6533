"""The port's backward, forward-backward and frameshift posterior
(ops/posterior.py) on the CPU, after tests/test_posterior.py :62, :73,
:87 and :157, and against the JAX functions on the same seeded inputs.

Tolerances: backward against forward rtol 1e-5 / atol 1e-3 (two float32
recursions); gamma rows sum to 1 within 2e-3; the finite differences as
the reference's test states them; against JAX, loglik rtol 1e-4,
ins_occupancy and del_mass rtol 1e-3 / atol 1e-4 (float32 sums in another
order)."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advntr_tpu.ops import posterior as jposterior
from advntr_tpu_torch import dna
from advntr_tpu_torch.config import Config
from advntr_tpu_torch.engine.finder import LocusModelCache, VNTRFinder
from advntr_tpu_torch.engine.simulate import mutate
from advntr_tpu_torch.models.compiler import compile_graph_sum
from advntr_tpu_torch.models.graph import (K_DELETE, K_INSERT, R_REPEAT,
                                           build_read_matcher)
from advntr_tpu_torch.models.profile import profile_for_repeats
from advntr_tpu_torch.models.reference_vntr import ReferenceVNTR
from advntr_tpu_torch.ops.posterior import (backward_batch, clean_neg,
                                            forward_backward_batch,
                                            indel_model, log_sub,
                                            posterior_indel_batch)
from advntr_tpu_torch.ops.viterbi import forward_batch

# the suite runs test files in parallel worker processes: one torch thread
# each keeps them from oversubscribing the cores
torch.set_num_threads(1)

CPU = torch.device("cpu")

READS = [
    "ACGTTGCACAGCAGCAGCAGCAACAGTTACGGAT",
    "TTGCACAGCAGCAGCAGTTACG",
    "CAGCAGCAGCAGCAACAG",
    "ACGTTGCACAGCTGCAGCAGTTACGGAT",
    "ACGTTGCACAGCAGGCAGCAGCAACAGTTACG",   # 1bp insertion in copy 2
    "ACGTTGCACAGCGCAGCAGCAACAGTTACGGAT",  # 1bp deletion in copy 1
]


def np_forward(log_T, log_E, log_start, log_end, codes):
    """Float64 dense forward oracle (host, no latching needed)."""
    v = log_start + log_E[:, codes[0]]
    for c in codes[1:]:
        v = np.logaddexp.reduce(v[:, None] + log_T, axis=0) + log_E[:, c]
    return float(np.logaddexp.reduce(v + log_end))


def small_model():
    trans, emis = profile_for_repeats(["CAGCAG", "CAGCAG", "CAACAG"], 0.05)
    return build_read_matcher("ACGTTGCA", "TTACGGAT", trans, emis, 3, 0.05)


def _batch(reads=READS):
    rows = [dna.encode(r) for r in reads]
    batch, lengths = dna.pad_batch(rows, multiple=8)
    return rows, torch.as_tensor(batch), torch.as_tensor(lengths)


def _indel_inputs(g):
    """(full closure, delete-free closure, the seven host tables and the
    insert mask) of the posterior."""
    full = compile_graph_sum(g)
    nodel = compile_graph_sum(
        g, drop_silent=lambda s: s.kind == K_DELETE and s.region == R_REPEAT)
    emitting = [s for i, s in enumerate(g.states)
                if not s.is_silent and i not in (g.start, g.end)]
    occ_mask = np.array(
        [s.kind == K_INSERT and s.region == R_REPEAT for s in emitting],
        dtype=np.float32)
    host = (full[0], full[1], full[2], full[3],
            log_sub(full[0], nodel[0]), log_sub(full[2], nodel[2]),
            log_sub(full[3], nodel[3]))
    return full, nodel, host, occ_mask


def test_backward_matches_forward():
    T, E, S, F = (clean_neg(x, CPU) for x in compile_graph_sum(small_model()))
    _, batch, lengths = _batch()
    fwd = forward_batch(T, E, S, F, batch, lengths).numpy()
    bwd = backward_batch(T, E, S, F, batch, lengths).numpy()
    np.testing.assert_allclose(bwd, fwd, rtol=1e-5, atol=1e-3)
    want = np.asarray(jposterior.backward_batch(
        *(jposterior.clean_neg(x) for x in compile_graph_sum(small_model())),
        jnp.asarray(batch.numpy()), jnp.asarray(lengths.numpy())))
    np.testing.assert_allclose(bwd, want, rtol=1e-5, atol=1e-3)


def test_gamma_rows_are_distributions():
    T, E, S, F = (clean_neg(x, CPU) for x in compile_graph_sum(small_model()))
    rows, batch, lengths = _batch()
    loglik, gamma = forward_backward_batch(T, E, S, F, batch, lengths)
    assert gamma.shape == (batch.shape[1], len(rows), T.shape[0])
    gamma = gamma.numpy()
    for b, codes in enumerate(rows):
        for t in (0, len(codes) // 2, len(codes) - 1):
            assert np.exp(gamma[t, b]).sum() == pytest.approx(1.0, abs=2e-3)
    want_ll, _ = jposterior.forward_backward_batch(
        *(jposterior.clean_neg(x) for x in compile_graph_sum(small_model())),
        jnp.asarray(batch.numpy()), jnp.asarray(lengths.numpy()))
    np.testing.assert_allclose(loglik.numpy(), np.asarray(want_ll),
                               rtol=1e-5, atol=1e-3)


def test_posterior_indel_finite_difference():
    g = small_model()
    full, nodel, host, occ_mask = _indel_inputs(g)
    T_del, S_del, F_del = host[4:]
    rows, batch, lengths = _batch()
    out = posterior_indel_batch(
        *(clean_neg(x, CPU) for x in host), torch.as_tensor(occ_mask),
        batch, lengths)
    loglik, loglik_b, occ, dm = (
        out[k].numpy().astype(np.float64) for k in
        ("loglik", "loglik_backward", "ins_occupancy", "del_mass"))
    np.testing.assert_allclose(loglik_b, loglik, rtol=1e-5, atol=1e-3)

    CLIP = np.float64(-1e30)
    fin = lambda x: np.where(np.isfinite(x), x, CLIP)

    def tilt_del(theta):
        return tuple(np.logaddexp(fin(nd), np.where(d > -1e29, d + theta,
                                                    CLIP))
                     for nd, d in ((nodel[0], T_del), (nodel[2], S_del),
                                   (nodel[3], F_del)))

    E64 = fin(full[1])
    T64, S64, F64 = fin(full[0]), fin(full[2]), fin(full[3])
    eps = 1e-4
    for b, codes in enumerate(rows):
        assert loglik[b] == pytest.approx(
            np_forward(T64, E64, S64, F64, codes), rel=1e-4, abs=2e-3), b
        # expected delete-routed transitions == d loglik / d theta
        Tp, Sp, Fp = tilt_del(+eps)
        Tm, Sm, Fm = tilt_del(-eps)
        fd_del = (np_forward(Tp, E64, Sp, Fp, codes)
                  - np_forward(Tm, E64, Sm, Fm, codes)) / (2 * eps)
        assert dm[b] == pytest.approx(fd_del, rel=2e-2, abs=2e-2), b
        # expected masked-state emissions == d loglik / d theta on log_E
        Ep = E64 + eps * occ_mask[:, None]
        Em = E64 - eps * occ_mask[:, None]
        fd_occ = (np_forward(T64, Ep, S64, F64, codes)
                  - np_forward(T64, Em, S64, F64, codes)) / (2 * eps)
        assert occ[b] == pytest.approx(fd_occ, rel=2e-2, abs=2e-2), b
    assert occ[4] > occ[0] + 0.5          # insertion read
    assert dm[5] > dm[0] + 0.5            # deletion read


def _seeded_reads(seed, n, pattern="CAGCAG"):
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        hap = "ACGTTGCA" + pattern * rng.randint(1, 4) + "TTACGGAT"
        a = rng.randint(0, 6)
        s = hap[a:a + rng.randint(8, len(hap) - a)]
        out.append(mutate(s, 0.05, rng))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_posterior_indel_equals_jax(seed):
    full, nodel, host, occ_mask = _indel_inputs(small_model())
    # the port's own build of the same tables (the finder's)
    own, own_mask = indel_model(small_model())
    for a, b in zip(own + (own_mask,), host + (occ_mask,)):
        np.testing.assert_array_equal(a, b)
    _, batch, lengths = _batch(READS + _seeded_reads(seed, 20))
    got = posterior_indel_batch(
        *(clean_neg(x, CPU) for x in host), torch.as_tensor(occ_mask),
        batch, lengths)
    want = jposterior.posterior_indel_batch(
        *(jposterior.clean_neg(x) for x in host), jnp.asarray(occ_mask),
        jnp.asarray(batch.numpy()), jnp.asarray(lengths.numpy()))
    for key in ("loglik", "loglik_backward"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-4, err_msg=key)
    for key in ("ins_occupancy", "del_mass"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-3, atol=1e-4, err_msg=key)


def test_frameshift_posterior_end_to_end():
    """A homozygous repeat deletion raises posterior delete mass and the
    port's frameshift call carries the posterior report (the reference's
    test_posterior.py:157 fixture)."""
    rng = random.Random(7)
    pattern = "ACGGTCAGT"
    left = "".join(rng.choice("ACGT") for _ in range(80))
    right = "".join(rng.choice("ACGT") for _ in range(80))
    copies = 8
    ref = ReferenceVNTR(25561, pattern, 3000, "chr1")
    ref.repeat_segments = [pattern] * copies
    ref.left_flanking_region = left
    ref.right_flanking_region = right
    ref.estimated_repeats = copies
    read_length = 72
    vntr_b = pattern * 3 + pattern[:4] + pattern[5:] + pattern * (copies - 4)
    hap = left + vntr_b + right
    reads = []
    for h in range(2):
        for k in range(int(len(hap) * 15 / read_length)):
            start = rng.randint(0, len(hap) - read_length)
            reads.append((f"h{h}r{k}",
                          mutate(hap[start:start + read_length], 0.001, rng)))
    finder = VNTRFinder(ref, Config(),
                        model_cache=LocusModelCache(device="cpu"))
    result = finder.find_frameshift([], reads, read_length=read_length,
                                    posterior=True)
    assert result is not None and result.startswith("D")
    assert result.posterior is not None and result.posterior["reads"] > 0
    assert result.posterior["mean_delete_mass"] > 0.05
    assert result.lr_support > 0
