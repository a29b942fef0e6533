"""An 8-locus panel in two model-shape buckets through both CLIs: the
port's grouped dispatch (``--device cpu``) must give the reference's call
at every locus."""

import os

import torch

from advntr_tpu import cli as jax_cli
from advntr_tpu_torch import cli
from advntr_tpu_torch.synthetic import write_panel

# the suite runs test files in parallel worker processes: one torch thread
# each keeps them from oversubscribing the cores
torch.set_num_threads(1)


def _calls(main, db, bam, workdir, extra=()):
    os.makedirs(workdir, exist_ok=True)
    out = os.path.join(workdir, "out.txt")
    main(["genotype", "-a", bam, "-m", db, "--working_directory",
          str(workdir), "--disable_logging", "-o", out] + list(extra))
    lines = open(out).read().splitlines()
    return dict(zip(lines[0::2], lines[1::2]))


def test_panel_calls_match_reference(tmp_path):
    db, bam, truth = write_panel(str(tmp_path), n_loci=8, read_length=100,
                                 coverage=15)
    ref = _calls(jax_cli.main, db, bam, tmp_path / "jax")
    got = _calls(cli.main, db, bam, tmp_path / "torch", ["--device", "cpu"])
    assert got == ref
    assert len(got) == 8
    right = sum(got[str(v)] == "%d/%d" % ab for v, ab in truth.items())
    assert right >= 6, (got, truth)
