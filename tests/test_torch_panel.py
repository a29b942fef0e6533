"""An 8-locus panel in two model-shape buckets through both CLIs: the
port's grouped dispatch (``--device cpu``) must give the reference's call
at every locus, with its default kernel and with
``ADVNTR_TPU_KERNEL=struct`` (the reference CLI's CPU default, whose text
it then equals byte for byte)."""

import os

import pytest
import torch

from advntr_tpu import cli as jax_cli
from advntr_tpu_torch import cli
from advntr_tpu_torch.synthetic import write_panel

# the suite runs test files in parallel worker processes: one torch thread
# each keeps them from oversubscribing the cores
torch.set_num_threads(1)


def _text(main, db, bam, workdir, extra=()):
    os.makedirs(workdir, exist_ok=True)
    out = os.path.join(workdir, "out.txt")
    main(["genotype", "-a", bam, "-m", db, "--working_directory",
          str(workdir), "--disable_logging", "-o", out] + list(extra))
    return open(out).read()


def _calls(text):
    lines = text.splitlines()
    return dict(zip(lines[0::2], lines[1::2]))


@pytest.fixture(scope="module")
def panel(tmp_path_factory):
    """The panel's files, its simulated genotypes and the reference CLI's
    text on it."""
    tmp = tmp_path_factory.mktemp("torch_panel")
    db, bam, truth = write_panel(str(tmp), n_loci=8, read_length=100,
                                 coverage=15)
    return dict(tmp=tmp, db=db, bam=bam, truth=truth,
                ref=_text(jax_cli.main, db, bam, tmp / "jax"))


def test_panel_calls_match_reference(panel):
    got = _calls(_text(cli.main, panel["db"], panel["bam"],
                       panel["tmp"] / "torch", ["--device", "cpu"]))
    assert got == _calls(panel["ref"])
    assert len(got) == 8
    right = sum(got[str(v)] == "%d/%d" % ab
                for v, ab in panel["truth"].items())
    assert right >= 6, (got, panel["truth"])


def test_panel_struct_kernel_text_equals_reference(panel, monkeypatch):
    """Each shape bucket scores as one grouped run of the structured
    decoder."""
    from advntr_tpu_torch.engine import device_analytics as da
    monkeypatch.setenv("ADVNTR_TPU_KERNEL", "struct")
    groups = []
    grouped = da.read_stats_struct_grouped

    def spy(stacked, meta, seqs, *a, **k):
        groups.append(seqs.shape[0])
        return grouped(stacked, meta, seqs, *a, **k)

    monkeypatch.setattr(da, "read_stats_struct_grouped", spy)
    got = _text(cli.main, panel["db"], panel["bam"],
                panel["tmp"] / "torch_struct", ["--device", "cpu"])
    assert got == panel["ref"]
    assert sorted(groups) == [4, 4]
