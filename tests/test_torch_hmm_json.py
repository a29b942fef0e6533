"""Trained-HMM JSON models in the port against the JAX package: the
pomegranate round trip and its Viterbi (test_hmm_json.py:33), the finder's
trained-model cache (:67), the dense fallback's statistics equal to the
reference's ``da.read_stats`` on the same imported model, and genotype
runs with ``Config.trained_hmms_dir`` giving the reference's text."""

import dataclasses
import io
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advntr_tpu.config import Config as JConfig
from advntr_tpu.engine import analyzer as janalyzer
from advntr_tpu.engine import device_analytics as jda
from advntr_tpu.engine import finder as jfinder
from advntr_tpu.models import db as jdb
from advntr_tpu.models import hmm_json as jhmm_json
from advntr_tpu.models.compiler import compile_graph as jcompile_graph
from advntr_tpu_torch import dna
from advntr_tpu_torch.config import Config
from advntr_tpu_torch.engine import analyzer, device_analytics as da
from advntr_tpu_torch.engine.finder import LocusModelCache, VNTRFinder
from advntr_tpu_torch.models import db
from advntr_tpu_torch.models.compiler import compile_graph
from advntr_tpu_torch.models.graph import build_read_matcher
from advntr_tpu_torch.models.hmm_json import (graph_from_pomegranate_json,
                                              graph_to_pomegranate_json,
                                              save_trained_hmm)
from advntr_tpu_torch.models.profile import profile_for_repeats
from advntr_tpu_torch.models.reference_vntr import ReferenceVNTR
from advntr_tpu_torch.ops.viterbi import viterbi_numpy
from advntr_tpu_torch.synthetic import (build_cstb_locus, encode_reads,
                                        refused_topology,
                                        simulate_cstb_reads,
                                        write_cstb_sample, write_trained_hmms)

# the suite runs test files in parallel worker processes: one torch thread
# each keeps them from oversubscribing the cores
torch.set_num_threads(1)

LEFT, RIGHT = "ACGTTGCA", "TTACGGAT"
UNITS = ["CAGCAG", "CAGCAG", "CAACAG"]
READS = [
    "ACGTTGCACAGCAGCAGCAGCAACAGTTACGGAT",
    "TTGCACAGCAGCAGCAGTTACG",
    "ACGTTGCACAGCTGCAGCAGTTACGGAT",
]


def _build():
    trans, emis = profile_for_repeats(UNITS, 0.05)
    return build_read_matcher(LEFT, RIGHT, trans, emis, 3, 0.05)


def test_round_trip_graph_and_viterbi():
    """test_hmm_json.py:33 on the port, and the port's JSON text equal to
    the reference's for the same graph."""
    g = _build()
    doc = graph_to_pomegranate_json(g)
    assert doc == jhmm_json.graph_to_pomegranate_json(g)
    assert json.loads(doc)["class"] == "HiddenMarkovModel"
    g2 = graph_from_pomegranate_json(doc)
    by_name = {s.name: s for s in g.states}
    by_name2 = {s.name: s for s in g2.states}
    assert set(by_name) == set(by_name2)
    for name, s in by_name.items():
        s2 = by_name2[name]
        assert (s.kind, s.region, s.unit) == (s2.kind, s2.region, s2.unit)
        assert s.emission == s2.emission
    def edge_names(graph):
        return {(graph.states[a].name, graph.states[b].name): p
                for (a, b), p in graph.edges.items()}
    assert edge_names(g) == edge_names(g2)
    art1, art2 = compile_graph(g), compile_graph(g2)
    for read in READS:
        codes = dna.encode(read)
        logp1, path1 = viterbi_numpy(art1, codes)
        logp2, path2 = viterbi_numpy(art2, codes)
        assert logp1 == pytest.approx(logp2, rel=1e-12, abs=1e-12)
        np.testing.assert_array_equal(path1, path2)


def _ref_vntr():
    ref = ReferenceVNTR(77, "CAGCAG", 100, "chr1")
    ref.repeat_segments = UNITS
    ref.left_flanking_region = LEFT
    ref.right_flanking_region = RIGHT
    return ref


@pytest.mark.parametrize("refused", [False, True])
def test_finder_uses_trained_hmm_cache(tmp_path, refused):
    """test_hmm_json.py:67 on the port: the imported model scores reads
    through the finder (structured, or the dense fallback for a topology
    the extractor refuses), each logp that of the float64 Viterbi of the
    imported model, the model cached per read length; no file for a read
    length gives the built model."""
    g = refused_topology(_build()) if refused else _build()
    save_trained_hmm(g, str(tmp_path / "77_34.json"))
    config = dataclasses.replace(Config(), trained_hmms_dir=str(tmp_path))
    f = VNTRFinder(_ref_vntr(), config, model_cache=LocusModelCache("cpu"))
    lm = f.get_model(34)
    assert (lm.dense is not None) == refused
    assert (lm.model is None) == refused
    assert f.get_model(34) is lm
    scored, _ = f.score_reads([], [(f"r{i}", r) for i, r in enumerate(READS)],
                              34, model=lm)
    assert len(scored) == len(READS)
    art = compile_graph(g)
    for s, read in zip(scored, READS):
        want, _ = viterbi_numpy(art, dna.encode(read))
        assert s.logp == pytest.approx(want, rel=1e-3, abs=0.05)
    f2 = VNTRFinder(_ref_vntr(), config, model_cache=LocusModelCache("cpu"))
    assert f2._load_trained_hmm(99) is None
    assert f2.get_model(99).dense is None


@pytest.mark.parametrize("read_length,n_reads,chunk_rows", [
    (60, 48, None), (100, 40, 7)])
def test_dense_fallback_stats_equal_reference(read_length, n_reads,
                                              chunk_rows):
    """The refused CSTB model through the port's dense fallback (rows in
    chunks) and the reference's ``da.read_stats`` on the same imported
    JSON, padded alike: every statistic and the paths equal, logp within
    rtol 1e-4 / atol 1e-2."""
    g, _, left, right, pattern = build_cstb_locus(read_length)
    doc = graph_to_pomegranate_json(refused_topology(g))
    cache = LocusModelCache("cpu")
    g_own = graph_from_pomegranate_json(doc)
    lm = cache._build_imported(g_own, compile_graph(g_own))
    assert lm.model is None and lm.n_pad % 128 == 0
    reads = simulate_cstb_reads(left, pattern, right, read_length, n_reads)
    reads[3] = reads[3][:1]
    reads[5] = reads[5][:17]
    seqs, lens = encode_reads(reads, read_length + 4)
    n = lm.dense.n_states
    chunk = {} if chunk_rows is None else \
        {"chunk_bytes": chunk_rows * 4 * n * n}
    got = da.read_stats_dense(lm.dense, torch.as_tensor(seqs),
                              torch.as_tensor(lens), return_path=True,
                              **chunk)
    g_ref = jhmm_json.graph_from_pomegranate_json(doc)
    dm = jda.DeviceModel.from_artifact(
        jfinder._pad_artifact(jcompile_graph(g_ref), lm.n_pad))
    want = jda.read_stats(dm.flat(), jnp.asarray(seqs), jnp.asarray(lens),
                          return_path=True)
    assert sorted(got) == sorted(want)
    np.testing.assert_allclose(got["logp"].numpy(), np.asarray(want["logp"]),
                               rtol=1e-4, atol=1e-2)
    for k in want:
        if k != "logp":
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]), err_msg=k)


def _genotype_with(pkg, db_path, bam, workdir, config):
    """``genotype`` of every locus in ``db_path`` through the package's
    GenomeAnalyzer with ``config``, as its CLI runs it (one I/O thread, no
    worker pool); the text."""
    config = dataclasses.replace(config, io_threads=1)
    os.makedirs(workdir)
    buf = io.StringIO()
    refs = pkg["db"].load_unique_vntrs_data(db_path)
    kw = {"device": "cpu"} if pkg["analyzer"] is analyzer else {}
    a = pkg["analyzer"].GenomeAnalyzer(
        refs, [r.id for r in refs], str(workdir) + "/", "text", False, None,
        bam, config=config, out=buf, **kw)
    a.find_repeat_counts_from_alignment_file(bam)
    if pkg is OWN:
        a.model_cache.close()
    return buf.getvalue()


OWN = {"analyzer": analyzer, "db": db, "config": Config}
REF = {"analyzer": janalyzer, "db": jdb, "config": JConfig}


@pytest.fixture(scope="module")
def cstb(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_trained")
    db_path, bam = write_cstb_sample(str(tmp), coverage=20)
    return {"db": db_path, "bam": bam, "dir": tmp}


@pytest.mark.parametrize("refused", [False, True])
def test_genotype_with_trained_hmms_equals_reference(cstb, refused):
    """The CSTB 2/5 fixture with ``trained_hmms_dir`` holding the locus's
    own model (structured) or its refused variant (the dense fallback, a
    locus scored alone): the reference's text, 2/5, and with the
    structured import the same text as without it."""
    name = "refused" if refused else "same"
    hmms = write_trained_hmms(str(cstb["dir"] / name), cstb["db"], 100,
                              refused=refused)
    texts = {}
    for label, pkg in (("own", OWN), ("ref", REF)):
        config = dataclasses.replace(pkg["config"](), trained_hmms_dir=hmms)
        texts[label] = _genotype_with(pkg, cstb["db"], cstb["bam"],
                                      cstb["dir"] / f"{name}_{label}",
                                      config)
    assert texts["own"] == texts["ref"]
    assert texts["own"].split() == ["301645", "2/5"]
    if not refused:
        plain = _genotype_with(OWN, cstb["db"], cstb["bam"],
                               cstb["dir"] / "plain", Config())
        assert plain == texts["own"]
