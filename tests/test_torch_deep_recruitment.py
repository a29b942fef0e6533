"""The port's DNN pre-gate (engine/deep_recruitment.py) against the JAX
package's on seeded inputs: embeddings exactly equal, predictions within
atol 1e-6 with equal decisions, three epochs of training from the same
initial parameters within atol 1e-5 (1e-4 with the 50-unit layer, see
below), ``.npz`` files read both ways, and
``genotype`` with a gate model the reference wrote: the same text and the
same rows gated as ``advntr_tpu.cli``."""

import os
import random

import jax
import numpy as np
import pytest
import torch

from advntr_tpu import cli as jax_cli
from advntr_tpu import dna as jdna
from advntr_tpu.engine import deep_recruitment as jdr
from advntr_tpu.engine import finder as jfinder
from advntr_tpu_torch import cli, dna
from advntr_tpu_torch.engine import deep_recruitment as dr
from advntr_tpu_torch.engine import finder
from advntr_tpu_torch.synthetic import CSTB_PATTERN, rand_seq, \
    write_cstb_sample

# the suite runs test files in parallel worker processes: one torch thread
# each keeps them from oversubscribing the cores
torch.set_num_threads(1)

CPU = torch.device("cpu")
MOTIF = "CAGCAGTCGATT"


def _reads(seed, n=40):
    """Seeded reads of 1-120 bases with Ns, and motif-rich ones."""
    rng = random.Random(seed)
    reads = ["".join(rng.choice("ACGTN" if i % 3 else "ACGT")
                     for _ in range(rng.randint(1, 120))) for i in range(n)]
    return reads + [(MOTIF * 12)[rng.randint(0, 11):][:100]
                    for _ in range(n // 4)]


def _embed_both(reads, multiple=8):
    batch, lengths = dna.pad_batch([dna.encode(s) for s in reads],
                                   multiple=multiple)
    return (np.asarray(jdr.embed_batch(batch, lengths)),
            dr.embed_batch(batch, lengths, CPU).numpy())


@pytest.mark.parametrize("seed,multiple", [(0, 8), (1, 4), (2, 32)])
def test_embeddings_equal_reference(seed, multiple):
    want, got = _embed_both(_reads(seed), multiple)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert got.sum() > 0


def _jax_params(second_layer, seed=0):
    return jdr.init_params(jax.random.PRNGKey(seed),
                           second_layer=second_layer)


@pytest.mark.parametrize("second_layer", [0, 50])
def test_predict_equals_reference(second_layer):
    want_emb, emb = _embed_both(_reads(3, 80))
    params = _jax_params(second_layer, seed=4)
    model = dr.RecruitmentMLP.from_numpy(params)
    assert model.has_second_layer == bool(second_layer)
    want = np.asarray(jdr.predict(params, want_emb))
    got = dr.predict(model, emb).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[:, 0] > got[:, 1],
                                  want[:, 0] > want[:, 1])


def _separation_data():
    """test_aux_components.py:10's data: 60 motif reads, 60 random."""
    rng = np.random.default_rng(0)
    pos = [(MOTIF * 10)[:100] for _ in range(60)]
    neg = ["".join(rng.choice(list("ACGT"), 100)) for _ in range(60)]
    batch, lengths = jdna.pad_batch([jdna.encode(s) for s in pos + neg],
                                    multiple=4)
    return batch, lengths, np.array([1] * 60 + [0] * 60)


# Three epochs at the reference's width end within 9.5e-7 of optax.  With
# the 50-unit layer five entries of w1, all in the column of one hidden
# unit whose gradient stays near zero, end 7.2e-5 apart: Adam divides a
# gradient by its running RMS, so float noise in a gradient near zero
# becomes a step of up to the learning rate.  That case is held at 1e-4,
# the card-against-CPU tolerance of chip_smoke.py.
@pytest.mark.parametrize("second_layer,atol", [(0, 1e-5), (50, 1e-4)])
def test_train_equals_reference(monkeypatch, second_layer, atol):
    """Three epochs from the JAX initial parameters (the port's
    ``init_params`` patched to carry them): every parameter within
    ``atol`` of optax's, and the same decisions."""
    batch, lengths, labels = _separation_data()
    emb = dr.embed_batch(batch, lengths, CPU).numpy()
    start = _jax_params(second_layer)
    monkeypatch.setattr(
        dr, "init_params",
        lambda first_layer=100, second_layer=0, generator=None:
        dr.RecruitmentMLP.from_numpy(start))
    want = jdr.train(emb, labels, epochs=3, second_layer=second_layer)
    got = dr.train(emb, labels, epochs=3, second_layer=second_layer,
                   device="cpu")
    moved = 0.0
    for name, value in got.to_numpy().items():
        np.testing.assert_allclose(value, np.asarray(want[name]), rtol=0,
                                   atol=atol, err_msg=name)
        moved = max(moved, float(np.abs(value - np.asarray(start[name]))
                                 .max()))
    assert moved > 1e-2      # the parameters did move
    p_got = dr.predict(got, emb).numpy()
    p_want = np.asarray(jdr.predict(want, emb))
    np.testing.assert_array_equal(p_got[:, 0] > p_got[:, 1],
                                  p_want[:, 0] > p_want[:, 1])


def test_dnn_recruitment_learns_separation():
    """test_aux_components.py:10 on the port, its own initial draw."""
    batch, lengths, labels = _separation_data()
    emb = dr.embed_batch(batch, lengths, CPU)
    model = dr.train(emb, labels, epochs=3, device="cpu")
    probs = dr.predict(model, emb).numpy()
    assert (probs[:60, 0] > probs[:60, 1]).mean() > 0.9
    assert (probs[60:, 0] < probs[60:, 1]).mean() > 0.9


def test_dnn_model_roundtrip(tmp_path):
    """test_aux_components.py:31 on the port."""
    model = dr.init_params(generator=torch.Generator().manual_seed(0))
    path = str(tmp_path / "model.npz")
    dr.save_model(model, path)
    loaded = dr.load_model(path)
    x = torch.zeros((2, dr.INPUT_DIM))
    torch.testing.assert_close(dr.predict(model, x), dr.predict(loaded, x),
                               rtol=0, atol=0)
    assert dr.load_model(str(tmp_path / "absent.npz")) is None


@pytest.mark.parametrize("second_layer", [0, 50])
def test_npz_read_by_both_packages(tmp_path, second_layer):
    """A file the reference wrote gives the port the same module, and one
    the port wrote gives the reference the same parameters."""
    params = _jax_params(second_layer, seed=7)
    ref_path = str(tmp_path / "ref.npz")
    jdr.save_model(params, ref_path)
    own = dr.load_model(ref_path)
    for name, value in own.to_numpy().items():
        np.testing.assert_array_equal(value, np.asarray(params[name]))
    own_path = str(tmp_path / "own.npz")
    dr.save_model(own, own_path)
    back = jdr.load_model(own_path)
    assert sorted(back) == sorted(params)
    for name in params:
        np.testing.assert_array_equal(np.asarray(back[name]),
                                      np.asarray(params[name]))
    with np.load(ref_path) as a, np.load(own_path) as b:
        assert a.files == b.files


# ---- genotype with a gate model the reference wrote -----------------------

@pytest.fixture(scope="module")
def gated(tmp_path_factory):
    """The CSTB 2/5 fixture and a gate the reference trained on reads of
    the locus's haplotypes against random reads, written to
    ``dnn_models/301645.npz`` under the fixture's directory."""
    tmp = tmp_path_factory.mktemp("torch_gate")
    db, bam = write_cstb_sample(str(tmp), coverage=20)
    left, right = rand_seq(1, 300), rand_seq(2, 300)
    rng = random.Random(3)
    pos = []
    for _ in range(60):
        hap = left[-120:] + CSTB_PATTERN * rng.choice([2, 5]) + right[:120]
        a = rng.randint(0, len(hap) - 100)
        pos.append(hap[a:a + 100])
    neg = [rand_seq(100 + i, 100) for i in range(60)]
    batch, lengths = jdna.pad_batch([jdna.encode(s) for s in pos + neg],
                                    multiple=8)
    params = jdr.train(np.asarray(jdr.embed_batch(batch, lengths)),
                       np.array([1] * 60 + [0] * 60), epochs=3)
    os.makedirs(tmp / "dnn_models")
    jdr.save_model(params, str(tmp / "dnn_models" / "301645.npz"))
    return {"db": db, "bam": bam, "dir": tmp}


def _rows_seen(monkeypatch, module):
    """Record the (read, orientation) rows each prepare_rows returns."""
    seen = []
    orig = module.VNTRFinder.prepare_rows

    def wrapped(self, mapped, unmapped):
        out = orig(self, mapped, unmapped)
        seen.append((len(mapped), len(unmapped), list(out[2])))
        return out

    monkeypatch.setattr(module.VNTRFinder, "prepare_rows", wrapped)
    return seen


def _genotype(main, gated, name, extra=()):
    wd = gated["dir"] / name
    os.makedirs(wd)
    out = str(wd / "out.txt")
    main(["genotype", "-a", gated["bam"], "-m", gated["db"],
          "--working_directory", str(wd), "--disable_logging", "-o", out]
         + list(extra))
    with open(out) as fh:
        return fh.read()


def test_genotype_with_reference_gate_equals_reference(gated, monkeypatch):
    monkeypatch.chdir(gated["dir"])
    ref_rows = _rows_seen(monkeypatch, jfinder)
    own_rows = _rows_seen(monkeypatch, finder)
    want = _genotype(jax_cli.main, gated, "jax")
    got = _genotype(cli.main, gated, "torch", ["--device", "cpu"])
    assert got == want
    assert got.splitlines() == ["301645", "2/5"]
    assert own_rows == ref_rows and len(own_rows) == 1
    n_mapped, n_unmapped, rows = own_rows[0]
    kept = len(rows) - n_mapped
    # the gate removed some orientations of unmapped reads and kept some
    assert 0 < kept < 2 * n_unmapped


def test_gate_device_error_propagates(gated, monkeypatch):
    """An error of the gate's device step ends the run; it is not turned
    into the locus's Error row."""
    monkeypatch.chdir(gated["dir"])

    def fail(*a, **k):
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")

    monkeypatch.setattr(dr, "predict", fail)
    with pytest.raises(RuntimeError, match="CUDA error"):
        _genotype(cli.main, gated, "device_error", ["--device", "cpu"])


def test_unreadable_gate_model_gives_the_reference_text(gated, tmp_path,
                                                        monkeypatch):
    """A gate file that cannot be read is a host error: the locus's Error
    row, as the reference prints it."""
    os.makedirs(tmp_path / "dnn_models")
    (tmp_path / "dnn_models" / "301645.npz").write_bytes(b"not a zip")
    monkeypatch.chdir(tmp_path)
    want = _genotype(jax_cli.main, gated, "bad_jax")
    got = _genotype(cli.main, gated, "bad_torch", ["--device", "cpu"])
    assert got == want
    assert got.splitlines() == ["301645", "Error"]
