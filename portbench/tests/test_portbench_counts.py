"""The roofline's counts against the reference's own model and a hand
count, and the import guard's whole-name comparison."""

import sys
import types

import pytest

from portbench import harness, roofline
from portbench.reference import hmm


@pytest.mark.parametrize("f_left,f_right,motif,copies", [
    (3, 4, 2, 2), (6, 5, 3, 4), (12, 12, 5, 3), (150, 150, 8, 19)])
def test_transitions_equal_the_reference_graph(f_left, f_right, motif,
                                               copies):
    locus = {"pattern": "ACGTACGTACGT"[:motif], "left": "GATTACA" * 30,
             "right": "TTAGGCA" * 30,
             "segments": ["ACGTACGTACGT"[:motif]] * 3}
    g, s, e = hmm.read_matcher(locus["left"][-f_left:],
                               locus["right"][:f_right], locus["segments"],
                               copies, 0.05)
    c = hmm.compile_graph(g, s, e)
    assert c.transitions == roofline.read_matcher_transitions(
        f_left, f_right, motif, copies)
    assert c.n_emit == roofline.emitting_states(f_left, f_right, motif,
                                                copies)


def test_hand_count():
    # flanks of 1: suffix start -> M1, D1, I0; I0 -> I0, D1, M1; M1, D1,
    # I1 -> I1, end: 3 + 3 + 6 = 12 a flank.  One unit of one position:
    # start -> I0, D1, M1; I0 -> 3; M1, I1, D1 -> 2 each: 12.
    # Connectors: the start, the 0.3 entry, the suffix end, three model
    # states, the first unit, end_repeats, its exit, three prefix states,
    # the end, the 0.7 entry to M1, the exit from M1: 15.
    assert roofline.read_matcher_transitions(1, 1, 1, 1) == 12 + 12 + 12 + 15
    ops, nbytes = roofline.decode_work(1, 1, 1, 1, [10, 20])
    assert ops == 2 * 51 * 30
    assert nbytes == 30 + 4 * (51 + 4 * 9) + 2 * 32
    ops, nbytes = roofline.align_work([100, 50], [100, 100])
    assert ops == 12 * 150 * 200 * 2
    assert roofline.bound_seconds(67e12, 0) == 1.0


def test_import_guard_compares_whole_top_level_names(monkeypatch):
    fake = types.ModuleType("x")
    for name in ("advntr_tpu_torch", "advntr_tpu_torch.cli", "jaxtyping",
                 "flaxen.core"):
        monkeypatch.setitem(sys.modules, name, fake)
    for name in ("jax", "jaxlib", "flax", "advntr_tpu"):
        monkeypatch.delitem(sys.modules, name, raising=False)
        monkeypatch.delitem(sys.modules, name + ".core", raising=False)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "advntr_tpu.engine", fake)
    monkeypatch.setitem(sys.modules, "jaxlib", fake)
    assert harness.forbidden_modules() == ["advntr_tpu", "jaxlib"]


def test_reference_and_harness_import_nothing_of_the_program():
    from pathlib import Path
    root = Path(harness.__file__).parent
    for f in list((root / "reference").glob("*.py")) + [
            root / "generate.py", root / "roofline.py", root / "trace.py"]:
        text = f.read_text()
        assert "import advntr" not in text and "from advntr" not in text
        assert "import jax" not in text and "from jax" not in text
