"""Model banks carried across the two packages: a bank file written by the
reference's ``build_locus_payload`` is read by the port's loader where
``advntr_tpu`` cannot be imported, gives the tables of a bank the port
built itself, and a pickle that names any other ``advntr_tpu`` class is
refused."""

import dataclasses
import gzip
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from advntr_tpu.engine import finder as jax_finder
from advntr_tpu.models.reference_vntr import ReferenceVNTR as JaxReferenceVNTR
from advntr_tpu_torch.engine import finder
from advntr_tpu_torch.models.reference_vntr import ReferenceVNTR
from advntr_tpu_torch.ops.struct_model import STACKED
from advntr_tpu_torch.synthetic import CSTB_PATTERN, rand_seq

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
LOCI = [(301645, CSTB_PATTERN, 9), (7, "CAGCAG", 17), (8, "ACGTTAC", 12)]


def _ref(cls, vid, pattern):
    ref = cls(vid, pattern, 5000, "chr21", "GENE", "Promoter", 3)
    ref.repeat_segments = [pattern] * 3
    ref.left_flanking_region = rand_seq(vid, 120)
    ref.right_flanking_region = rand_seq(vid + 1, 120)
    return ref


def _write_bank(bank_dir, payload, vid, copies):
    os.makedirs(bank_dir, exist_ok=True)
    path = finder.bank_payload_path(str(bank_dir), vid, copies, 100, 0.05)
    with gzip.open(path, "wb", compresslevel=1) as fh:
        pickle.dump(payload, fh)
    return path


def _tables(payload):
    art, sm = payload
    lm = finder.LocusModelCache(device="cpu")._build_from_payload(art, sm)
    return lm, {n: getattr(lm.model, n).numpy() for n in STACKED}


LOAD_WITHOUT_REFERENCE = r"""
import sys
sys.modules["jax"] = None
sys.modules["advntr_tpu"] = None
import numpy as np
from advntr_tpu_torch.engine import finder
art, sm = finder.load_reference_payload(sys.argv[1])
assert type(art).__module__ == "advntr_tpu_torch.models.compiler"
assert type(sm).__module__ == "advntr_tpu_torch.models.struct_compiler"
lm = finder.LocusModelCache(device="cpu")._build_from_payload(art, sm)
np.savez(sys.argv[2], **{n: getattr(lm.model, n).numpy()
                         for n in sys.argv[3].split(",")})
assert not [m for m in sys.modules if m.startswith("advntr_tpu.")]
"""


@pytest.mark.parametrize("vid,pattern,copies", LOCI)
def test_reference_bank_read_without_the_reference_package(
        tmp_path, vid, pattern, copies):
    ref_payload = jax_finder.build_locus_payload(
        _ref(JaxReferenceVNTR, vid, pattern), copies, 100, 0.05)
    assert type(ref_payload[0]).__module__ == "advntr_tpu.models.compiler"
    path = _write_bank(tmp_path / "ref_bank", ref_payload, vid, copies)
    out = tmp_path / "tables.npz"
    env = dict(os.environ, PYTHONPATH=str(REPO), HOME=str(tmp_path),
               TMPDIR=str(tmp_path), OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-c", LOAD_WITHOUT_REFERENCE, path, str(out),
         ",".join(STACKED)], cwd=tmp_path, env=env, capture_output=True,
        text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    own_payload = finder.build_locus_payload(
        _ref(ReferenceVNTR, vid, pattern), copies, 100, 0.05)
    own_path = _write_bank(tmp_path / "own_bank", own_payload, vid, copies)
    lm, own = _tables(finder.load_reference_payload(own_path))
    got = np.load(out)
    for name in STACKED:
        np.testing.assert_array_equal(got[name], own[name], err_msg=name)
    # the port's own bank names the port's own classes only
    with gzip.open(own_path, "rb") as fh:
        raw = fh.read()
    assert b"advntr_tpu_torch.models.compiler" in raw
    assert b"advntr_tpu.models" not in raw


def test_payload_from_arrays_is_the_in_memory_loader():
    vid, pattern, copies = LOCI[1]
    art, sm = jax_finder.build_locus_payload(
        _ref(JaxReferenceVNTR, vid, pattern), copies, 100, 0.05)
    fields = lambda obj: {f.name: getattr(obj, f.name)
                          for f in dataclasses.fields(obj)}
    own_art, own_sm = finder.payload_from_arrays(fields(art), fields(sm))
    assert type(own_art).__module__ == "advntr_tpu_torch.models.compiler"
    assert type(own_sm).__module__ == \
        "advntr_tpu_torch.models.struct_compiler"
    _, got = _tables((own_art, own_sm))
    _, want = _tables(finder.build_locus_payload(
        _ref(ReferenceVNTR, vid, pattern), copies, 100, 0.05))
    for name in STACKED:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


@pytest.mark.parametrize("obj", [
    JaxReferenceVNTR(1, "ACG", 0, "chr1"),      # advntr_tpu.models.* passes
    jax_finder.GenotypeResult(None, 0, 0, 0, 0.0),   # anything else does not
])
def test_other_reference_classes_are_refused(tmp_path, obj):
    path = tmp_path / "model.pkl.gz"
    with gzip.open(path, "wb") as fh:
        pickle.dump((obj, None), fh)
    if type(obj).__module__.startswith("advntr_tpu.models."):
        loaded, _ = finder.load_reference_payload(str(path))
        assert type(loaded) is ReferenceVNTR and loaded.pattern == "ACG"
    else:
        with pytest.raises(pickle.UnpicklingError, match="advntr_tpu"):
            finder.load_reference_payload(str(path))
