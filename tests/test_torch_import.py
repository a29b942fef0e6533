"""The port imports and genotypes with jax, the JAX package ``advntr_tpu``,
the JAX side's ``bench`` module, optax and sklearn all unimportable, never
imports any of them in its sources or in ``chip_smoke.py``, and takes the
flags of the paths it has ported."""

import os
import sqlite3
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import advntr_tpu_torch
from advntr_tpu_torch import cli
from advntr_tpu_torch.device import resolve_device

# the suite runs test files in parallel worker processes: one torch thread
# each keeps them from oversubscribing the cores
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PKG = Path(advntr_tpu_torch.__file__).parent

NO_JAX_RUN = r"""
import importlib, os, pkgutil, sys, tempfile
sys.modules["jax"] = None          # any import of these now fails
sys.modules["advntr_tpu"] = None
sys.modules["bench"] = None
sys.modules["optax"] = None
sys.modules["sklearn"] = None
import torch
torch.set_num_threads(1)
import advntr_tpu_torch
for mod in pkgutil.walk_packages(advntr_tpu_torch.__path__,
                                 "advntr_tpu_torch."):
    importlib.import_module(mod.name)
from advntr_tpu_torch import cli
from advntr_tpu_torch.synthetic import write_cstb_sample
for argv in (["--help"], ["genotype", "--help"], ["viewmodel", "--help"],
             ["addmodel", "--help"], ["delmodel", "--help"],
             ["buildbank", "--help"]):
    try:
        cli.main(argv)
    except SystemExit as e:
        assert e.code == 0, e.code
d = tempfile.mkdtemp()
db, bam = write_cstb_sample(d, coverage=20)
out = os.path.join(d, "out.txt")
cli.main(["genotype", "-a", bam, "-m", db, "--working_directory", d,
          "--disable_logging", "-o", out, "--device", "cpu"])
print(open(out).read().split())
assert not [m for m in sys.modules
            if m.startswith(("jax.", "advntr_tpu.", "bench.", "optax.",
                             "sklearn."))]
"""


def test_imports_and_genotypes_without_jax(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO), HOME=str(tmp_path),
               TMPDIR=str(tmp_path), OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", NO_JAX_RUN], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "genotype" in res.stdout and "--device" in res.stdout
    for sub in ("addmodel", "delmodel", "buildbank"):
        assert "usage: advntr-tpu-torch %s" % sub in res.stdout
    assert res.stdout.strip().splitlines()[-1] == "['301645', '2/5']"


FORBIDDEN_IMPORT = re.compile(
    r"^\s*(from|import)\s+(jax|bench|advntr_tpu|optax|sklearn)(\.|\s|$)",
    re.M)


def test_sources_never_import_jax():
    """No source of the port, nor chip_smoke.py, imports jax, the JAX
    package, bench, optax or sklearn (``advntr_tpu_torch`` itself passes
    the pattern)."""
    sources = [p for p in PKG.rglob("*.py")
               if "build" not in p.relative_to(PKG).parts]
    assert len(sources) > 30
    names = {p.relative_to(PKG).as_posix() for p in sources}
    assert {"ops/viterbi.py", "ops/posterior.py", "ops/baum_welch.py",
            "engine/analytics.py", "engine/finder.py",
            "engine/deep_recruitment.py", "engine/training.py",
            "models/hmm_json.py", "parallel/mesh.py",
            "parallel/distributed.py", "engine/reference_editor.py",
            "engine/read_screens.py", "engine/evaluation.py",
            "models/annotation.py", "models/db_build.py",
            "models/homology.py", "models/pattern_clustering.py",
            "ops/viterbi_struct.py", "native_bridge.py"} <= names
    sources.append(REPO / "chip_smoke.py")
    offenders = [(str(p), m.group(0).strip()) for p in sources
                 for m in FORBIDDEN_IMPORT.finditer(p.read_text())]
    assert offenders == []
    assert FORBIDDEN_IMPORT.search("from advntr_tpu.dna import encode\n")
    assert FORBIDDEN_IMPORT.search("    import bench\n")
    assert FORBIDDEN_IMPORT.search("    from sklearn.linear_model import "
                                   "LogisticRegression\n")
    assert FORBIDDEN_IMPORT.search("    import optax\n")
    assert not FORBIDDEN_IMPORT.search("from advntr_tpu_torch import dna\n")


def test_cuda_device_is_explicit():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("mps")


@pytest.mark.parametrize("flag,item", [("-fs", "A10"), ("-u", "A10"),
                                       ("--em", "A10")])
def test_unported_flags_name_their_roadmap_item(flag, item, tmp_path):
    """The flags of ROADMAP item ``item`` are ported: the CLI no longer
    refuses them and goes on to its inputs, where an empty models DB
    stops it."""
    assert not hasattr(cli, "NOT_PORTED")
    with pytest.raises(sqlite3.OperationalError) as exc:
        cli.main(["genotype", "-a", str(tmp_path / "x.bam"), flag,
                  "-m", str(tmp_path / "empty.db"), "--disable_logging",
                  "--device", "cpu"])
    assert item not in str(exc.value)


@pytest.mark.parametrize("argv,message", [
    (["-p"], "No input specified"),
    (["-f", "reads.fa"], "not supported for Illumina"),
])
def test_long_read_flags_are_accepted(argv, message):
    """-p, -f, --naive and --log_pacbio_reads parse; -p is no longer
    refused as unported, and a FASTA input still needs -p."""
    args = cli.build_parser().parse_args(
        ["genotype", "-p", "-f", "x.fa", "--naive", "--log_pacbio_reads"])
    assert args.pacbio and args.naive and args.log_pacbio_reads
    assert not hasattr(cli, "NOT_PORTED")
    with pytest.raises(SystemExit) as exc:
        cli.main(["genotype", "--device", "cpu"] + argv)
    assert message in str(exc.value.code)
