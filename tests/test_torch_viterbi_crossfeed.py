"""The port against the JAX reference at the seams of the kernel pair:
the reference forward's origin planes fed through the port's backward
walk, the int32 origin planes that large models use, and random models
against the structured kernel."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import advntr_tpu.ops.pallas_viterbi as pv
from advntr_tpu_torch.ops import viterbi_fused as vf
from test_torch_viterbi_fused import (CASES, READS, _batch,
                                      _check_against_jax, _models,
                                      _random_reads)

# the suite runs test files in parallel worker processes: one torch thread
# each keeps them from oversubscribing the cores
torch.set_num_threads(1)


def test_read_stats_matches_jax_forced_int32_origins(monkeypatch):
    art, sm, pm, tm = _models(CASES[1])
    assert vf.origin_params(tm.P, tm.nb)[0] == torch.int16
    monkeypatch.setattr(pv, "_FORCE_ORIGIN32", True)
    jax.clear_caches()
    try:
        _check_against_jax(CASES[1], READS, origin32=True)
    finally:
        jax.clear_caches()
    _, _, oMI, _ = vf.fused_forward(tm, torch.zeros(2, 8, dtype=torch.int8),
                                    torch.full((2,), 8), origin32=True)
    assert oMI.dtype == torch.int32


def test_backward_walk_on_jax_planes():
    """Cross-feed: the reference forward's planes, relaid (L, B, .), go
    through the port's backward walk and give the reference's path and
    statistics exactly."""
    case = CASES[1]
    art, sm, pm, tm = _models(case)
    _, batch, lengths = _batch(READS + _random_reads(case, 22, seed=5))
    B = batch.shape[0]
    best, bstate, oMI4, oXH4 = pv.pallas_fused_forward(
        pm, jnp.asarray(batch)[None], jnp.asarray(lengths)[None],
        interpret=True)
    path_ref, stats_ref = pv.pallas_backward_stats(
        pm, jnp.asarray(lengths), bstate.reshape(B), oMI4, oXH4,
        interpret=True)
    path, stats = vf.backward_stats(
        tm, torch.as_tensor(lengths), torch.as_tensor(np.array(bstate[0])),
        torch.as_tensor(np.array(oMI4[0])),
        torch.as_tensor(np.array(oXH4[0])))
    np.testing.assert_array_equal(path.numpy(), np.asarray(path_ref))
    np.testing.assert_array_equal(stats.numpy(), np.asarray(stats_ref))


def test_forward_twin_planes_equal_jax_planes():
    """The forward twin's end states and origin planes are the reference
    kernel's, bit for bit: a walk held right on the twin's planes (as the
    CUDA kernel is on the card, where the reference cannot run) is held
    right on the reference's."""
    case = CASES[1]
    art, sm, pm, tm = _models(case)
    _, batch, lengths = _batch(READS + _random_reads(case, 22, seed=5))
    _, bstate, oMI4, oXH4 = pv.pallas_fused_forward(
        pm, jnp.asarray(batch)[None], jnp.asarray(lengths)[None],
        interpret=True)
    twin = vf.fused_forward_reference(tm, torch.as_tensor(batch),
                                      torch.as_tensor(lengths))
    for got, want in zip(twin[1:], (bstate, oMI4, oXH4)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want[0]))


@pytest.mark.parametrize("window", [1, 8, 32])
def test_windowed_walk_on_jax_planes(window):
    """The window scheme on the reference forward's planes: the path and
    statistics of the reference's own walk and of the port's
    column-by-column walk, exactly (integers)."""
    case = CASES[1]
    art, sm, pm, tm = _models(case)
    _, batch, lengths = _batch(READS + _random_reads(case, 22, seed=5))
    B = batch.shape[0]
    best, bstate, oMI4, oXH4 = pv.pallas_fused_forward(
        pm, jnp.asarray(batch)[None], jnp.asarray(lengths)[None],
        interpret=True)
    path_ref, stats_ref = pv.pallas_backward_stats(
        pm, jnp.asarray(lengths), bstate.reshape(B), oMI4, oXH4,
        interpret=True)
    planes = (torch.as_tensor(lengths), torch.as_tensor(np.array(bstate[0])),
              torch.as_tensor(np.array(oMI4[0])),
              torch.as_tensor(np.array(oXH4[0])))
    path, stats = vf.backward_stats_windowed_reference(tm, *planes,
                                                       window=window)
    np.testing.assert_array_equal(path.numpy(), np.asarray(path_ref))
    np.testing.assert_array_equal(stats.numpy(), np.asarray(stats_ref))
    path_w, stats_w = vf.backward_stats_reference(tm, *planes)
    assert torch.equal(path, path_w) and torch.equal(stats, stats_w)


def _soak_model(rng):
    def rand_seq(n):
        return "".join(rng.choice("ACGT") for _ in range(n))
    plen = rng.choice([5, 11])
    pattern = rand_seq(plen)
    units = []
    for _ in range(3):
        u = list(pattern)
        if rng.random() < 0.5:
            u[rng.randrange(plen)] = rng.choice("ACGT")
        units.append("".join(u))
    left, right = rand_seq(rng.choice([12, 20])), rand_seq(rng.choice([12, 20]))
    copies = rng.choice([3, 5])
    reads = []
    for _ in range(12):
        hap = left + pattern * rng.randint(1, copies + 2) + right
        kind = rng.random()
        if kind < 0.5:
            a = rng.randint(0, max(0, len(hap) - 15))
            read = hap[a:rng.randint(a + 10, len(hap))]
        elif kind < 0.7:
            read = rand_seq(rng.randint(10, 60))
        else:
            read = hap
        chars = list(read)
        for _ in range(rng.randint(0, 3)):
            chars[rng.randrange(len(chars))] = rng.choice("ACGT")
        reads.append("".join(chars))
    return (units, left, right, copies, rng.choice([0.05, 0.3])), reads


@pytest.mark.parametrize("trial", range(3))
def test_random_models_meet_the_struct_contract(trial):
    """Random motifs, flanks, copy counts and error rates (the soak of
    tests/test_pallas_viterbi.py:211): the port's plain pipeline against
    the structured XLA kernel."""
    from advntr_tpu.engine import device_analytics as jda
    from advntr_tpu.ops.viterbi_struct import StructDeviceModel
    from advntr_tpu_torch.engine import device_analytics as tda
    from advntr_tpu_torch.ops.struct_model import TorchStructModel
    from advntr_tpu_torch.synthetic import locus_model, rescore
    case, reads = _soak_model(random.Random(20240817 + trial))
    art, sm = locus_model(*case)
    rows, batch, lengths = _batch(reads)
    meta = tuple(jnp.asarray(x) for x in
                 (art.kind, art.region, art.exp_base, art.unit))
    ref = jda.read_stats_struct(
        StructDeviceModel.from_struct(sm, art).flat(), meta,
        jnp.asarray(batch), jnp.asarray(lengths), sm.suffix_last)
    out = tda.read_stats(TorchStructModel.from_payload(art, sm, "cpu"),
                         torch.as_tensor(batch), torch.as_tensor(lengths),
                         return_path=True)
    l1 = np.asarray(ref["logp"])
    np.testing.assert_allclose(out["logp"].numpy(), l1, rtol=1e-4, atol=1e-2)
    keep = l1 > -1e20
    for k in vf.STAT_KEYS:
        np.testing.assert_array_equal(out[k].numpy()[keep],
                                      np.asarray(ref[k])[keep], err_msg=k)
    for b, codes in enumerate(rows):
        if keep[b]:
            s = rescore(art, out["path"][b].numpy()[: len(codes)], codes)
            assert s == pytest.approx(float(l1[b]), rel=1e-4, abs=1e-2)
