"""The generator: panels fixed by their configuration, samples by the seed
(seeds past 32 bits too), and files the port reads as a user's."""

import copy
import json
from pathlib import Path

import pytest

from portbench import generate

ROOT = Path(__file__).resolve().parents[2]


def _load(kind, name):
    return json.loads((ROOT / "portbench" / kind / f"{name}.json").read_text())


def _small(config, traffic):
    config, traffic = copy.deepcopy(config), copy.deepcopy(traffic)
    config["panel"]["loci"] = 4
    if "context_bp" in config["panel"]:
        config["panel"]["context_bp"] = 800
        config["panel"]["long_every"] = 0
        traffic["reads"]["read_length"] = 1500
    return config, traffic


@pytest.mark.parametrize("config,traffic", [
    ("illumina_hg19_6719", "wgs30_bank"), ("pacbio_hg19_8960", "clr15")])
def test_deterministic_by_seed(config, traffic):
    cfg, tr = _small(_load("configs", config), _load("traffic", traffic))
    panel = generate.make_panel(cfg)
    assert panel == generate.make_panel(cfg)
    big = 2 ** 31 + 987_654_321
    scale = 4 / cfg["published"]["loci"]
    a, ta, pa = generate.make_sample(panel, tr, big, 0, scale)
    b, tb, pb = generate.make_sample(panel, tr, big, 0, scale)
    c, _, _ = generate.make_sample(panel, tr, big + 1, 0, scale)
    d, _, _ = generate.make_sample(panel, tr, big, 1, scale)
    assert a == b and ta == tb and pa == pb
    assert a != c and a != d
    assert all(set(s) <= set("ACGT") for _, s in a)
    assert len({n for n, _ in a}) == len(a)


def test_full_panels_have_their_published_shapes():
    ill = generate.make_panel(_load("configs", "illumina_hg19_6719"))
    assert len(ill) == 512
    assert {len(lc.pattern) for lc in ill} <= {8, 10, 12, 15, 20, 24}
    assert all(len(lc.pattern) * lc.allele_range[1] < 140 for lc in ill)
    assert max(len(lc.pattern) * lc.allele_range[1] for lc in ill) >= 130
    pb = generate.make_panel(_load("configs", "pacbio_hg19_8960"))
    assert len(pb) == 48
    long_ = [lc for lc in pb if len(lc.pattern) * lc.ref_copies > 2000]
    assert len(long_) == 3
    assert all(lc.alleles is not None for lc in pb)


def test_files_read_by_the_port(tmp_path):
    from advntr_tpu_torch.io.bam import BamReader
    from advntr_tpu_torch.io.fasta import read_any
    from advntr_tpu_torch.models.db import load_unique_vntrs_data
    cfg, tr = _small(_load("configs", "illumina_hg19_6719"),
                     _load("traffic", "wgs30_bank"))
    panel = generate.make_panel(cfg)
    reads, _, placed = generate.make_sample(panel, tr, 3, 0,
                                            40 / cfg["published"]["loci"])
    n_bg = generate.background_count(tr, 40 / cfg["published"]["loci"])
    assert n_bg > 0 and sum(n.startswith("bg") for n, _ in reads) == n_bg
    assert 0 < len(placed) < len(reads) - n_bg
    db, bam, fa = (str(tmp_path / n) for n in ("p.db", "s.bam", "s.fa"))
    generate.write_db(db, panel)
    generate.write_bam(bam, reads, placed)
    generate.write_fasta(fa, reads)
    rows = load_unique_vntrs_data(db)
    assert [r.id for r in rows] == [lc.vid for lc in panel]
    assert rows[0].repeat_segments == [panel[0].pattern] * panel[0].ref_copies
    seqs = dict(reads)
    with BamReader(bam) as r:
        got = [(x.query_name, x.seq, x.is_unmapped, x.reference_start)
               for x in r]
        # the index finds every aligned read over each locus, and no other
        for lc in panel:
            lo, hi = lc.start - 500, lc.start + 200
            want = sorted(n for n, p in placed.items()
                          if p < hi and p + len(seqs[n]) > lo)
            assert sorted(x.query_name for x in r.fetch("chr1", lo, hi)) \
                == want
        assert list(r.fetch("chr1", 0, 5_000)) == []
    assert sorted(got) == sorted(
        (n, s, n not in placed, placed.get(n, -1)) for n, s in reads)
    starts = [g[3] for g in got if not g[2]]
    assert starts == sorted(starts) and all(g[2] for g in got[len(starts):])
    assert list(read_any(fa)) == reads
