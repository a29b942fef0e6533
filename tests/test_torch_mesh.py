"""The port's scale-out over devices (advntr_tpu_torch/parallel/mesh.py)
against the reference's (advntr_tpu/parallel/mesh.py) on the CPU.

The port's shards are CPU devices running the plain twins; the
reference's run its Pallas pair in interpret mode over the 8-device
virtual CPU mesh of tests/conftest.py.  Sharded and unsharded statistics
must be exactly equal; against the reference, ROADMAP's contract:
statistics exactly equal, logp within rtol 1e-4 / atol 1e-2."""

import dataclasses
import io
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import advntr_tpu.ops.pallas_viterbi as pv
import advntr_tpu.parallel.mesh as jmesh
from advntr_tpu import dna
from advntr_tpu.engine import device_analytics as jda
from advntr_tpu.ops.viterbi_struct import StructDeviceModel as JStruct
from advntr_tpu_torch.engine import device_analytics as tda
from advntr_tpu_torch.ops import viterbi_fused as vf
from advntr_tpu_torch.ops.struct_model import TorchStructModel
from advntr_tpu_torch.ops.viterbi_struct import StructDeviceModel
from advntr_tpu_torch.parallel import mesh
from advntr_tpu_torch.synthetic import locus_model

# the suite runs test files in parallel worker processes: one torch thread
# each keeps them from oversubscribing the cores
torch.set_num_threads(1)

LOGP_TOL = dict(rtol=1e-4, atol=1e-2)
CPU = torch.device("cpu")
# four loci of one shape (6 bp units, 8 bp flanks, 3 copies)
CASES = [
    (["CAGCAG", "CAGCAG", "CAACAG"], "ACGTTGCA", "TTACGGAT", 3),
    (["TTGACC", "TTGACC", "TTGTCC"], "GGATCCAT", "CATGATCG", 3),
    (["ACCGTA", "ACCGTA", "ACCGTA"], "TGCATGCA", "GATTACAG", 3),
    (["GATCGA", "GATCGA", "GTTCGA"], "CCGTAGCA", "ATGCCGTA", 3),
]
B = 8


@pytest.fixture(scope="module")
def group():
    """Four same-shape loci, each with its own ragged batch of B seeded
    reads (lengths 1..40), padded to one (G, B, L); the port's models and
    the reference's stacked Pallas tables and metadata."""
    built = [locus_model(*case) for case in CASES]
    tms = [TorchStructModel.from_payload(art, sm, "cpu")
           for art, sm in built]
    assert len({tm.shape_key() for tm in tms}) == 1
    rows = []
    for g, (units, left, right, copies) in enumerate(CASES):
        rng = random.Random(41 + g)
        reads = []
        for _ in range(B - 1):
            hap = left + units[0] * rng.randint(1, copies + 2) + right
            a = rng.randint(0, max(0, len(hap) - 12))
            reads.append(hap[a:a + rng.randint(10, len(hap) - a)])
        rows.append([dna.encode(r) for r in reads + ["A"]])
    L = 8 * -(-max(len(c) for r in rows for c in r) // 8)
    seqs = np.zeros((len(rows), B, L), dtype=np.int8)
    lens = np.ones((len(rows), B), dtype=np.int32)
    for g, r in enumerate(rows):
        for b, codes in enumerate(r):
            seqs[g, b, :len(codes)] = codes
            lens[g, b] = len(codes)
    pallas = [pv.PallasStructModel.from_struct(sm, art).flat()
              for art, sm in built]
    metas = [tuple(jnp.asarray(x) for x in
                   (art.kind, art.region, art.exp_base, art.unit))
             for art, _ in built]
    return tms, seqs, lens, pallas, metas


@pytest.fixture(scope="module")
def struct_group():
    """The group's loci as the structured decoder's models: the port's,
    their metadata and suffix indices, and the reference's flat tables."""
    built = [locus_model(*case) for case in CASES]
    structs = [StructDeviceModel.from_struct(sm, art, "cpu")
               for art, sm in built]
    metas = [tuple(torch.as_tensor(np.asarray(x)) for x in
                   (art.kind, art.region, art.exp_base, art.unit))
             for art, _ in built]
    sls = [sm.suffix_last for _, sm in built]
    flats = [JStruct.from_struct(sm, art).flat() for art, sm in built]
    return structs, metas, sls, flats


def _stack(flats, idx):
    return tuple(jnp.stack([flats[g][i] for g in idx])
                 for i in range(len(flats[0])))


@pytest.mark.parametrize("group_size,batch,n", [
    (8, 512, 1), (8, 512, 2), (8, 512, 8), (4, 512, 8), (3, 512, 8),
    (8, 3, 2), (4, 6, 8), (6, 512, 4)])
def test_panel_mesh_factoring_equals_reference(group_size, batch, n):
    """The port factors n devices as the reference does, None cases
    included (one device; a reads axis that does not divide the batch)."""
    got = mesh.panel_mesh(group_size, batch, devices=[CPU] * n)
    want = jmesh.panel_mesh(group_size, batch, devices=jax.devices()[:n])
    if want is None:
        assert got is None
        return
    assert (got.n_loci, got.n_reads) == (want.shape["loci"],
                                         want.shape["reads"])
    assert all(d == CPU for row in got.devices for d in row)


def test_panel_mesh_takes_no_cpu_device_unless_given():
    assert mesh.visible_devices("cpu") == []
    assert mesh.panel_mesh(8, 512, device_type="cpu") is None
    with pytest.raises(ValueError, match="must use all"):
        mesh.make_mesh(n_loci=3, n_reads=2, devices=[CPU] * 8)


@pytest.mark.parametrize("n_devices,G", [(2, 4), (8, 4), (2, 3), (8, 3)])
def test_sharded_equals_unsharded_and_reference(group, n_devices, G):
    """A group of G loci split over [cpu] * n_devices (loci 2 x reads 1,
    or loci 4 x reads 2): every statistic equal to the port's unsharded
    launch, and to the reference's sharded Pallas run under the contract.
    G = 3 is a short chunk the loci axis does not divide: the port splits
    it unevenly, the reference pads it to 4 by repeating its last locus
    (analyzer.py:567-577), whose row is dropped."""
    tms, seqs, lens, pallas, metas = group
    m = mesh.panel_mesh(4, B, devices=[CPU] * n_devices)
    assert (m.n_loci, m.n_reads) == {2: (2, 1), 8: (4, 2)}[n_devices]
    tseqs, tlens = torch.as_tensor(seqs[:G]), torch.as_tensor(lens[:G])
    got = mesh.sharded_grouped_read_stats(m, tms[:G], tseqs, tlens)
    whole = tda.read_stats_grouped(tms[:G], tseqs, tlens)
    assert set(got) == set(whole)
    for k, v in whole.items():
        assert got[k].shape == (G, B) and torch.equal(got[k], v), k
    idx = list(range(G)) + [G - 1] * (4 - G)
    jm = jmesh.make_mesh(n_loci=m.n_loci, n_reads=m.n_reads,
                         devices=jax.devices()[:n_devices])
    ref = jmesh.sharded_grouped_read_stats(
        jm, _stack(pallas, idx), _stack(metas, idx),
        jnp.asarray(seqs[idx]), jnp.asarray(lens[idx]), kernel="pallas",
        interpret=True)
    np.testing.assert_allclose(got["logp"].numpy(),
                               np.asarray(ref["logp"])[:G], **LOGP_TOL)
    for k in vf.STAT_KEYS:
        np.testing.assert_array_equal(got[k].numpy(),
                                      np.asarray(ref[k])[:G], err_msg=k)


def test_sharded_launches_once_a_nonempty_shard(group, monkeypatch):
    """Each shard is one grouped call on its own rows; a loci slice with
    no locus launches nothing; a batch the reads axis does not divide is
    refused."""
    tms, seqs, lens, _, _ = group
    calls = []
    orig = vf.viterbi_stats_grouped

    def spy(s, q, n, *a, **kw):
        calls.append((s.G, tuple(q.shape)))
        return orig(s, q, n, *a, **kw)

    monkeypatch.setattr(vf, "viterbi_stats_grouped", spy)
    m = mesh.make_mesh(n_loci=4, n_reads=2, devices=[CPU] * 8)
    L = seqs.shape[2]
    mesh.sharded_grouped_read_stats(m, tms[:3], torch.as_tensor(seqs[:3]),
                                    torch.as_tensor(lens[:3]))
    assert calls == [(1, (1, B // 2, L))] * 6
    with pytest.raises(ValueError, match="does not divide"):
        mesh.sharded_grouped_read_stats(
            m, tms, torch.as_tensor(seqs[:, :5]),
            torch.as_tensor(lens[:, :5]))


def test_stack_to_its_own_device_is_itself(group):
    stack = TorchStructModel.stack(group[0])
    assert stack.to("cpu") is stack


def _analyzer_runs(monkeypatch, tmp_path, kernel="pallas"):
    """The analyzer's text on one simulated 2/4 locus with 8 CPU devices
    visible and with none, under ``kernel``, and the (loci, reads, kernel)
    of each sharded dispatch."""
    from advntr_tpu_torch.config import Config
    from advntr_tpu_torch.engine.analyzer import GenomeAnalyzer
    from advntr_tpu_torch.engine.simulate import simulate_diploid_reads
    from advntr_tpu_torch.io.bam import BamRead, BamWriter
    from advntr_tpu_torch.models.reference_vntr import ReferenceVNTR

    rng = random.Random(31)
    pattern = "GATCGATTCGAA"
    ref = ReferenceVNTR(55, pattern, 1000, "chr1")
    ref.repeat_segments = [pattern] * 3
    ref.left_flanking_region = "".join(
        rng.choice("ACGT") for _ in range(200))
    ref.right_flanking_region = "".join(
        rng.choice("ACGT") for _ in range(200))
    reads, _, _ = simulate_diploid_reads(
        ref.left_flanking_region, pattern, 2, 4, ref.right_flanking_region,
        read_length=100, coverage=30, error_rate=0.002, seed=9)
    bam_path = str(tmp_path / "s.bam")
    with BamWriter(bam_path, ["chr1"], [100000]) as w:
        for name, seq in reads:
            w.write(BamRead(name, 4, -1, -1, 0, [], seq, [38] * len(seq)))

    calls = []
    orig = mesh.sharded_grouped_read_stats

    def spy(m, *a, **kw):
        calls.append((m.n_loci, m.n_reads, kw.get("kernel", "pallas")))
        return orig(m, *a, **kw)

    outputs = {}
    for tag in ("sharded", "single"):
        if tag == "sharded":
            monkeypatch.setattr(mesh, "visible_devices",
                                lambda device_type: [CPU] * 8)
            monkeypatch.setattr(mesh, "sharded_grouped_read_stats", spy)
        else:
            monkeypatch.undo()
        monkeypatch.setenv("ADVNTR_TPU_KERNEL", kernel)
        buf = io.StringIO()
        analyzer = GenomeAnalyzer([ref], [55], str(tmp_path / tag) + "/",
                                  "text", config=Config(), out=buf,
                                  input_file=bam_path, device="cpu")
        analyzer.find_repeat_counts_from_alignment_file(bam_path)
        analyzer.model_cache.close()
        outputs[tag] = buf.getvalue()
    return calls, outputs


def test_analyzer_uses_sharded_dispatch(monkeypatch, tmp_path):
    """The counterpart of test_mesh.py::test_analyzer_uses_sharded_dispatch:
    with 8 devices visible the analyzer's grouped dispatch routes through
    the mesh, and the text equals the single-device run's and 2/4."""
    calls, outputs = _analyzer_runs(monkeypatch, tmp_path)
    assert calls == [(8, 1, "pallas")], \
        "sharded dispatch not used with 8 devices"
    assert outputs["sharded"] == outputs["single"]
    assert outputs["sharded"].strip().splitlines() == ["55", "2/4"]


def test_analyzer_struct_groups_use_sharded_dispatch(monkeypatch, tmp_path):
    """Under ``ADVNTR_TPU_KERNEL=struct`` the analyzer's struct groups go
    through the mesh with ``kernel="struct"``, and give the single-device
    run's text."""
    calls, outputs = _analyzer_runs(monkeypatch, tmp_path, "struct")
    assert calls == [(8, 1, "struct")]
    assert outputs["sharded"] == outputs["single"]
    assert outputs["sharded"].strip().splitlines() == ["55", "2/4"]


@pytest.mark.parametrize("n_devices,G", [(2, 4), (8, 4), (8, 3)])
def test_struct_sharded_equals_one_launch_and_reference(
        group, struct_group, n_devices, G):
    """``kernel="struct"``: the group split over [cpu] * n_devices equals
    one grouped run of the structured decoder, and the reference's sharded
    struct run (reference analyzer.py:609-624), every key bit for bit."""
    _, seqs, lens, _, metas = group
    structs, tmetas, sls, flats = struct_group
    m = mesh.panel_mesh(4, B, devices=[CPU] * n_devices)
    tseqs, tlens = torch.as_tensor(seqs[:G]), torch.as_tensor(lens[:G])
    got = mesh.sharded_grouped_read_stats(
        m, structs[:G], tseqs, tlens, kernel="struct", metas=tmetas[:G],
        suffix_lasts=sls[:G])
    whole = tda.read_stats_struct_grouped(
        StructDeviceModel.stack(structs[:G]), tda.stack_meta(tmetas[:G]),
        tseqs, tlens, torch.tensor(sls[:G]))
    assert set(got) == set(whole)
    for k, v in whole.items():
        assert got[k].shape == (G, B) and torch.equal(got[k], v), k
    idx = list(range(G)) + [G - 1] * (4 - G)
    jm = jmesh.make_mesh(n_loci=m.n_loci, n_reads=m.n_reads,
                         devices=jax.devices()[:n_devices])
    ref = jmesh.sharded_grouped_read_stats(
        jm, _stack(flats, idx), _stack(metas, idx), jnp.asarray(seqs[idx]),
        jnp.asarray(lens[idx]), suffix_lasts=np.array(sls)[idx],
        kernel="struct")
    assert set(ref) == set(got)
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(),
                                      np.asarray(ref[k])[:G], err_msg=k)
    with pytest.raises(ValueError, match="unknown kernel"):
        mesh.sharded_grouped_read_stats(m, structs[:G], tseqs, tlens,
                                        kernel="dense")


def test_dense_mesh_functions_equal_reference(group):
    """``stack_models``, ``multi_locus_read_stats`` (loci 4 x reads 2) and
    ``data_parallel_read_stats`` (8 devices) over the port's DenseModel
    and ``read_stats_dense`` equal the reference's over its DeviceModel
    and dense ``read_stats``: statistics exactly, logp within rtol 1e-4 /
    atol 1e-2; and each equals the model's own unsharded run."""
    _, seqs, lens, _, _ = group
    arts = [locus_model(*case)[0] for case in CASES]
    dense = [tda.DenseModel.from_artifact(art, "cpu") for art in arts]
    jdense = [jda.DeviceModel.from_artifact(art) for art in arts]
    stacked = mesh.stack_models(dense)
    for f in dataclasses.fields(tda.DenseModel):
        assert torch.equal(getattr(stacked, f.name)[2],
                           getattr(dense[2], f.name)), f.name
    tseqs, tlens = torch.as_tensor(seqs), torch.as_tensor(lens)
    m = mesh.make_mesh(n_loci=4, n_reads=2, devices=[CPU] * 8)
    got = mesh.multi_locus_read_stats(m, stacked, tseqs, tlens)
    want = jmesh.multi_locus_read_stats(
        jmesh.make_mesh(n_loci=4, n_reads=2, devices=jax.devices()[:8]),
        jmesh.stack_models(jdense), jnp.asarray(seqs), jnp.asarray(lens))
    one = mesh.data_parallel_read_stats(
        mesh.make_mesh(n_loci=1, n_reads=8, devices=[CPU] * 8), dense[1],
        tseqs[1], tlens[1])
    jone = jmesh.data_parallel_read_stats(
        jmesh.make_mesh(n_loci=1, n_reads=8, devices=jax.devices()[:8]),
        jdense[1].flat(), jnp.asarray(seqs[1]), jnp.asarray(lens[1]))
    assert set(got) == set(want) and set(one) == set(jone)
    for k in want:
        alone = [tda.read_stats_dense(dense[g], tseqs[g], tlens[g])[k]
                 for g in range(len(dense))]
        assert torch.equal(got[k], torch.stack(alone)), k
        assert torch.equal(one[k], alone[1]), k
        for mine, ref in ((got[k], want[k]), (one[k], jone[k])):
            if k == "logp":
                np.testing.assert_allclose(mine.numpy(), np.asarray(ref),
                                           **LOGP_TOL)
            else:
                np.testing.assert_array_equal(mine.numpy(), np.asarray(ref),
                                              err_msg=k)
    with pytest.raises(ValueError, match="do not divide"):
        mesh.multi_locus_read_stats(m, stacked, tseqs[:3], tlens[:3])
