"""The port's path analytics against the reference's recorded fixture
(tests/data/hmm_utils.json: a real visited-state sequence with its expected
repeat segments, the fixture of tests/test_analytics.py), and the backward
walk's in-walk statistics against the same analytics on decoded paths."""

import json
import os
import re

import numpy as np
import pytest
import torch

from advntr_tpu.engine import analytics as jan
from advntr_tpu_torch import dna
from advntr_tpu_torch.engine import analytics as tan
from advntr_tpu_torch.engine import device_analytics as tda
from advntr_tpu_torch.models.graph import (K_INSERT, K_MATCH, R_PREFIX,
                                           R_REPEAT, R_SUFFIX)
from advntr_tpu_torch.ops import viterbi_fused as vf
from advntr_tpu_torch.ops.struct_model import TorchStructModel
from advntr_tpu_torch.synthetic import locus_model

# the suite runs test files in parallel worker processes: one torch thread
# each keeps them from oversubscribing the cores
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def fixture():
    path = os.path.join(os.path.dirname(__file__), "data", "hmm_utils.json")
    with open(path) as fh:
        data = json.load(fh)
    data["visited"] = data["visited_states"].split(",")
    return data


def _fixture_path(visited, sequence):
    """The fixture's emitting states as an artifact-space path: one index
    per distinct state name, with the (kind, region, exp_base, unit)
    vectors those names spell out.  A match state expects the base it
    emitted first."""
    names, index = [], {}
    kind, region, exp_base, unit, path = [], [], [], [], []
    emitted = [s for s in visited if re.match(r"[MI]\d", s)]
    assert len(emitted) == len(sequence)
    for name, base in zip(emitted, dna.encode(sequence)):
        if name not in index:
            index[name] = len(names)
            names.append(name)
            where = name.split("_")[1]
            kind.append(K_MATCH if name[0] == "M" else K_INSERT)
            region.append({"prefix": R_PREFIX, "suffix": R_SUFFIX}.get(
                where, R_REPEAT))
            unit.append(int(where) if where.isdigit() else 0)
            exp_base.append(int(base))
        path.append(index[name])
    meta = tuple(torch.tensor(x) for x in (kind, region, exp_base, unit))
    return meta, torch.tensor([path])


def test_repeat_segments_on_fixture(fixture):
    """The port's copy of the segment splitter gives the fixture's repeats
    from the region after the truncated leading unit."""
    visited, sequence = fixture["visited"], fixture["sequence"]
    lead = visited.index("unit_end_0") - 1
    lengths = tan.repeating_pattern_lengths(visited)
    assert lengths == jan.repeating_pattern_lengths(visited)
    assert lengths == [len(r) for r in fixture["correct_repeats"]]
    assert tan.repeat_segments_from_region(visited, sequence[lead:]) == \
        fixture["correct_repeats"]


@pytest.mark.parametrize("keep", [250, 200, 119, 62, 33])
def test_analytics_from_path_on_fixture(fixture, keep):
    """analytics_from_path on the recorded path (and on its heads: reads
    that end earlier: in the flank, at the repeats' end, after a whole unit)
    gives what the reference's string-based analytics count on the same
    visited states."""
    visited, sequence = fixture["visited"], fixture["sequence"]
    meta, path = _fixture_path(visited, sequence)
    # the states up to the ``keep``-th emitted base
    n_emitted = np.cumsum([bool(re.match(r"[MI]\d", s)) for s in visited])
    head = visited[:int(np.searchsorted(n_emitted, keep)) + 1]
    seqs = torch.as_tensor(dna.encode(sequence)[None, :])
    out = tda.analytics_from_path(meta, torch.zeros(1), path, seqs,
                                  torch.tensor([keep]))
    assert int(out["repeats"]) == jan.count_repeats(head)
    assert int(out["n_matches"]) == jan.count_matches(head)
    assert int(out["repeat_bp"]) == jan.count_repeat_bp_matches(head)
    assert int(out["left_flank_bp"]) == jan.left_flank_size(head)
    assert int(out["right_flank_bp"]) == jan.right_flank_size(head)
    if keep == len(sequence):
        # what tests/test_analytics.py states of the whole fixture
        assert int(out["repeats"]) == 9
        assert int(out["left_flank_bp"]) == 0
        assert int(out["right_flank_bp"]) == 131
        assert int(out["repeat_bp"]) == 4 + sum(
            len(r) for r in fixture["correct_repeats"])


@pytest.mark.parametrize("window", [None, 32])
def test_walk_statistics_on_fixture_reads(fixture, window):
    """A locus made of the fixture's repeats and right flank decodes the
    fixture's read and pieces of it; the walk's statistics (column by
    column, and by the window scheme) equal analytics_from_path on the
    decoded paths."""
    sequence = fixture["sequence"]
    units = fixture["correct_repeats"][:3]
    right = sequence[-131:][:40]
    art, sm = locus_model(units, "ACGTTGCATTGACCGTAAGC", right, 9)
    tm = TorchStructModel.from_payload(art, sm, "cpu")
    read = sequence[:119 + 40]
    reads = [read, read[30:], read[:100], read[4:64], read[-45:], "A", "CT"]
    batch, lens = dna.pad_batch([dna.encode(r) for r in reads], multiple=8)
    seqs, lens = torch.as_tensor(batch), torch.as_tensor(lens)
    best, bstate, oMI, oXH = vf.fused_forward(tm, seqs, lens)
    if window is None:
        path_s, stats = vf.backward_stats(tm, lens, bstate, oMI, oXH)
    else:
        path_s, stats = vf.backward_stats_windowed_reference(
            tm, lens, bstate, oMI, oXH, window=window)
    out = vf.finish_stats(best, stats, tm.struct_to_art[path_s.long()])
    meta = tuple(torch.as_tensor(x) for x in
                 (art.kind, art.region, art.exp_base, art.unit))
    oracle = tda.analytics_from_path(meta, best, out["path"], seqs, lens)
    for k in vf.STAT_KEYS:
        np.testing.assert_array_equal(out[k].numpy(), oracle[k].numpy(),
                                      err_msg=k)
    # the whole read: 4 bp of a leading unit, 8 whole units, the flank
    assert int(out["right_flank_bp"][0]) == 40
    assert int(out["left_flank_bp"][0]) == 0
    assert int(out["repeats"][0]) == 9
