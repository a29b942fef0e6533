"""The port's CLI (``--device cpu``) against the JAX CLI on the CSTB 2/5
fixture of tests/test_cli_end_to_end.py: byte-identical text, BED and VCF
output (the port's default kernel, and ``ADVNTR_TPU_KERNEL=struct``),
resume from the JSONL checkpoint, and a bank written by the reference's
``buildbank`` consumed with no host model build.  The reference's CLI on
the CPU scores with its struct kernel, its CPU default."""

import json
import os

import pytest
import torch

from advntr_tpu import cli as jax_cli
from advntr_tpu_torch import cli
from advntr_tpu_torch.synthetic import write_cstb_sample

# the suite runs test files in parallel worker processes: one torch thread
# each keeps them from oversubscribing the cores
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def sample(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_cli")
    db, bam = write_cstb_sample(str(tmp))
    return {"db": db, "bam": bam, "dir": tmp}


def _genotype(main, sample, workdir, extra, device=()):
    os.makedirs(workdir, exist_ok=True)
    out = os.path.join(workdir, "out")
    main(["genotype", "-a", sample["bam"], "-m", sample["db"],
          "--working_directory", str(workdir), "--disable_logging",
          "-o", out] + list(extra) + list(device))
    with open(out) as fh:
        return fh.read()


def _reference(sample, fmt):
    """The reference CLI's output in ``fmt``, run once a module."""
    if fmt not in sample.setdefault("reference", {}):
        sample["reference"][fmt] = _genotype(
            jax_cli.main, sample, sample["dir"] / f"jax_{fmt}", ["-of", fmt])
    return sample["reference"][fmt]


@pytest.mark.parametrize("fmt", ["text", "bed", "vcf"])
def test_output_identical_to_reference(sample, fmt):
    ref = _reference(sample, fmt)
    got = _genotype(cli.main, sample, sample["dir"] / f"torch_{fmt}",
                    ["-of", fmt], ["--device", "cpu"])
    assert got == ref
    if fmt == "text":
        assert got.splitlines() == ["301645", "2/5"]


def test_struct_kernel_text_equals_reference(sample, monkeypatch):
    """``ADVNTR_TPU_KERNEL=struct``: the port's structured decoder gives
    the reference CPU CLI's text, and no launch of B1 or B2 is asked for
    (nothing falls back to the other kernel)."""
    from advntr_tpu_torch.ops import viterbi_fused as vf
    monkeypatch.setenv("ADVNTR_TPU_KERNEL", "struct")
    calls = []
    monkeypatch.setattr(vf, "viterbi_stats_grouped",
                        lambda *a, **k: calls.append("pallas"))
    monkeypatch.setattr(vf, "viterbi_stats",
                        lambda *a, **k: calls.append("pallas"))
    got = _genotype(cli.main, sample, sample["dir"] / "torch_struct", [],
                    ["--device", "cpu"])
    assert got == _reference(sample, "text")
    assert got.splitlines() == ["301645", "2/5"] and calls == []


def test_resume_from_checkpoint(sample):
    wd = sample["dir"] / "resume"
    first = _genotype(cli.main, sample, wd, [], ["--device", "cpu"])
    assert first.splitlines() == ["301645", "2/5"]
    ckpt = wd / "results_checkpoint_sample.bam.jsonl"
    rec = json.loads(ckpt.read_text().splitlines()[0])
    assert rec["vid"] == 301645 and rec["copy_numbers"] == [2, 5]
    # tamper with the checkpoint to prove the second run replays it
    rec["copy_numbers"] = [7, 9]
    ckpt.write_text(json.dumps(rec) + "\n")
    second = _genotype(cli.main, sample, wd, [], ["--device", "cpu"])
    assert second.splitlines() == ["301645", "7/9"]


def test_reference_bank_consumed_without_host_build(sample, monkeypatch):
    wd = sample["dir"] / "bank"
    jax_cli.main(["buildbank", "-m", sample["db"], "--working_directory",
                  str(wd), "-l", "100", "-t", "1"])
    assert len(os.listdir(wd / "model_bank")) == 1
    import advntr_tpu_torch.models.bank as bank

    def boom(*a, **k):
        raise AssertionError("host model build ran despite a warm bank")

    monkeypatch.setattr(bank, "build_locus_payload", boom)
    got = _genotype(cli.main, sample, wd, [], ["--device", "cpu"])
    assert got.splitlines() == ["301645", "2/5"]
