"""The port's plain model tables against the reference's Pallas packing
(PallasStructModel.from_struct) of the same padded structured model."""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import advntr_tpu.ops.pallas_viterbi as pv
from advntr_tpu_torch.ops import struct_model as smod
from advntr_tpu_torch.ops.struct_model import TorchStructModel
from advntr_tpu_torch.synthetic import locus_model, padded_structured

# the suite runs test files in parallel worker processes: one torch thread
# each keeps them from oversubscribing the cores
torch.set_num_threads(1)

CASES = [
    (["CAGCAG", "CAGCAG", "CAACAG"], "ACGTTGCA", "TTACGGAT", 3),
    (["CGCGGGGCGGGG"] * 3, "ACGTACTGACGATCGATT", "TTACGGATGCAGTACGTA", 5),
    (["ACGTAC"] * 3, "GATTACAGATTACAGATT", "CCATGGCCATGG", 9),
]


def _pair(case):
    art, sm = locus_model(*case)
    return art, sm, pv.PallasStructModel.from_struct(sm, art), \
        TorchStructModel.from_payload(art, sm, "cpu")


@pytest.mark.parametrize("case", CASES)
def test_window_tables_match_reference(case):
    art, sm, pm, tm = _pair(case)
    P = tm.P
    np.testing.assert_array_equal(tm.Wd.numpy(), np.asarray(pm.Wd2)[:, :P])
    np.testing.assert_array_equal(np.asarray(pm.Wd2)[:, P:], 0.0)
    np.testing.assert_array_equal(tm.Wu.numpy(), np.asarray(pm.Wu))
    assert tm.r_unit == float(np.asarray(pm.r_unit)[0, 0])


@pytest.mark.parametrize("case", CASES)
def test_position_and_block_rows_match_reference(case):
    art, sm, pm, tm = _pair(case)
    P, nb = tm.P, tm.nb
    PM2, PB2 = np.asarray(pm.PM2), np.asarray(pm.PB2)
    pairs = {pv.W2_A: ("a_mm", "mi"), pv.W2_B: ("a_im", "ii"),
             pv.W2_C: ("a_dm", "di"), pv.W2_D: ("md", "idw"),
             pv.W2_X: ("xm", "xi"), pv.W2_LE: ("le_M", "le_I"),
             pv.W2_START: ("M_start", "I_start")}
    for r, (m_half, i_half) in pairs.items():
        np.testing.assert_array_equal(tm.row(m_half).numpy(), PM2[r, :P])
        np.testing.assert_array_equal(tm.row(i_half).numpy(), PM2[r, P:])
    np.testing.assert_array_equal(tm.row("xd").numpy(), PM2[pv.W2_XD, :P])
    np.testing.assert_array_equal(tm.blk_idx.numpy() + 2 * P,
                                  PM2[pv.W2_BLKID, :P])
    np.testing.assert_array_equal(tm.row("i0_i").numpy(), PB2[pv.B2_IH, :nb])
    np.testing.assert_array_equal(tm.row("hub_i0").numpy(),
                                  PB2[pv.B2_IH, nb:])
    np.testing.assert_array_equal(tm.row("I0_start").numpy(),
                                  PB2[pv.B2_START, :nb])
    np.testing.assert_array_equal(tm.row("le_I0").numpy(),
                                  PB2[pv.B2_LE, :nb])
    # the ones-row folds of the expansion matrices carry the entry weights
    W_hio = np.asarray(pm.W_hio)
    np.testing.assert_array_equal(tm.row("ent_m").numpy(), W_hio[-1, :P])
    np.testing.assert_array_equal(tm.row("i0_m").numpy(), W_hio[-1, P:])
    np.testing.assert_array_equal(tm.row("i0_d").numpy(),
                                  np.asarray(pm.W_i0e)[-1])
    np.testing.assert_array_equal(tm.row("hub_d").numpy(),
                                  np.asarray(pm.W_hube)[-1])
    # the one-hot block rows are blk_idx
    onehot = np.asarray(pm.W_i0e)[:nb]
    np.testing.assert_array_equal(onehot.argmax(axis=0), tm.blk_idx.numpy())


@pytest.mark.parametrize("case", CASES)
def test_emissions_and_extraction_match_reference(case):
    art, sm, pm, tm = _pair(case)
    P, nb, C = tm.P, tm.nb, tm.C
    EMB = np.asarray(pm.EMB)
    np.testing.assert_array_equal(tm.eM.numpy().T, EMB[:, :P])
    np.testing.assert_array_equal(tm.eI.numpy().T, EMB[:, P:2 * P])
    np.testing.assert_array_equal(tm.eI0.numpy().T, EMB[:, 2 * P:2 * P + nb])
    # the match-bit block marks each M position's expected base
    _, mbit = pv._origin_params(P, nb)
    bits = EMB[:, 2 * P + nb:3 * P + nb] - 1.5
    for base in range(4):
        np.testing.assert_array_equal(bits[base] == mbit,
                                      tm.exp_base.numpy() == base)
    ulsuf = np.asarray(pm.ulsuf)
    np.testing.assert_array_equal(ulsuf[:, :C].argmax(axis=0),
                                  tm.unit_last.numpy())
    assert ulsuf[:, C].argmax() == tm.suffix_last
    np.testing.assert_array_equal(tm.struct_to_art.numpy(),
                                  np.asarray(pm.struct_to_art))


@pytest.mark.parametrize("case", CASES)
def test_region_and_unit_match_decoded_pack(case):
    art, sm, pm, tm = _pair(case)
    P, nb = tm.P, tm.nb
    pack = np.concatenate([np.asarray(pm.packMI)[0],
                           np.asarray(pm.packB)[0, :nb]]).astype(np.int64)
    np.testing.assert_array_equal(tm.region.numpy(), pack >> 12)
    np.testing.assert_array_equal(tm.unit.numpy(), (pack & 0xFFF) - 1)


@pytest.mark.parametrize("P,nb", [(64, 10), (512, 18), (4064, 34),
                                  (4000, 96), (8192, 18)])
def test_origin_dtype_rule_matches_reference(P, nb):
    dtype, mbit = smod.origin_params(P, nb)
    ref_dtype, ref_mbit = pv._origin_params(P, nb)
    assert mbit == ref_mbit
    assert dtype == {np.dtype("int16"): torch.int16,
                     np.dtype("int32"): torch.int32}[np.dtype(ref_dtype)]
    assert smod.origin_params(P, nb, force32=True) == (torch.int32,
                                                       smod.MBIT32)


def test_production_locus_shape():
    """The production CSTB cell: n_states 927, P 512, C 16, nb 18, int16
    origin planes; the port's own locus and read simulation give the
    locus and the reads of the reference's bench.py."""
    import dataclasses

    import bench
    from advntr_tpu_torch.synthetic import (build_cstb_locus,
                                            simulate_cstb_reads)
    graph, art, left, right, pattern = build_cstb_locus(150)
    sm = padded_structured(graph, art, pos_bucket=128)
    tm = TorchStructModel.from_payload(art, sm, "cpu")
    assert (art.n_states, tm.P, tm.C, tm.nb) == (927, 512, 16, 18)
    assert smod.origin_params(tm.P, tm.nb)[0] == torch.int16
    _, ref_art, ref_left, ref_right, ref_pattern = bench.build_locus(150)
    assert (left, right, pattern) == (ref_left, ref_right, ref_pattern)
    for f in dataclasses.fields(ref_art):
        got, want = getattr(art, f.name), getattr(ref_art, f.name)
        if isinstance(want, np.ndarray):
            np.testing.assert_array_equal(got, want, err_msg=f.name)
        else:
            assert got == want, f.name
    assert simulate_cstb_reads(left, pattern, right, 150, 64, seed=9) == \
        bench.simulate_reads(left, pattern, right, 150, 64, seed=9)


def test_stack_adds_a_group_axis():
    """stack() of G same-shape models is each table with a leading group
    axis, contiguous; one model stacks as views; other shapes refuse."""
    same = [(["CAGCAG"] * 3, "ACGTTGCA", "TTACGGAT", 3),
            (["TTGACC"] * 3, "GGATCCAT", "CATGATCG", 3),
            (["ACCGTA"] * 3, "TGCATGCA", "GATTACAG", 3)]
    tms = [TorchStructModel.from_payload(*locus_model(*c), "cpu")
           for c in same]
    stack = TorchStructModel.stack(tms)
    assert (stack.G, stack.P, stack.nb, stack.C) == \
        (3, tms[0].P, tms[0].nb, tms[0].C)
    for name in smod.STACKED:
        table = getattr(stack, name)
        assert table.is_contiguous() and table.shape[0] == 3, name
        for g, tm in enumerate(tms):
            assert torch.equal(table[g], getattr(tm, name)), name
    assert stack.suffix_last.tolist() == [tm.suffix_last for tm in tms]
    assert stack.r_unit.tolist() == [tm.r_unit for tm in tms]
    one = TorchStructModel.stack(tms[:1])
    assert one.G == 1 and one.pos.data_ptr() == tms[0].pos.data_ptr()
    assert all(getattr(one, n).is_contiguous() for n in smod.STACKED)
    other = TorchStructModel.from_payload(*locus_model(*CASES[1]), "cpu")
    with pytest.raises(ValueError, match="cannot stack"):
        TorchStructModel.stack([tms[0], other])


def test_kernel_row_order_matches_tables():
    """csrc/viterbi_forward.cu indexes the float tables by enum; its row
    order must be POS_ROWS and BLK_ROWS."""
    src = (Path(smod.__file__).parent.parent / "csrc" /
           "viterbi_forward.cu").read_text()
    enums = re.findall(r"enum \{([^}]*)\}", src)
    pos = [n.strip() for n in enums[0].split(",") if n.strip()]
    blk = [n.strip() for n in enums[1].split(",") if n.strip()]
    assert pos == ["R_" + n.upper() for n in smod.POS_ROWS]
    assert blk == ["B_" + n.upper() for n in smod.BLK_ROWS]



def test_kernel_limits_match_wrapper():
    """The wrapper chooses the forward kernel's entry by the limits its
    first entry is compiled for (threads per CTA, units per lane of warp
    0, rounds): a model past any of them takes the wide entry, and only a
    forced first entry is refused."""
    from advntr_tpu_torch.ops import _kernels
    csrc = Path(smod.__file__).parent.parent / "csrc"
    src = (csrc / "viterbi_forward.cu").read_text()
    bounds = re.search(r"__launch_bounds__\((\d+), (\d+)\)", src)
    assert int(bounds.group(1)) == _kernels.MAX_THREADS
    upl = int(re.search(r"constexpr int MAX_UPL = (\d+);", src).group(1))
    assert 32 * upl == _kernels.MAX_UNITS
    rounds = int(re.search(r"constexpr int MAX_ROUNDS = (\d+);",
                           src).group(1))
    assert rounds == _kernels.MAX_ROUNDS
    assert (1 << rounds) >= _kernels.MAX_THREADS
    assert {(csrc / name).exists() for name in _kernels.SOURCES} == {True}
    art, sm = locus_model(["CAGCAG"] * 3, "ACGTTGCA", "TTACGGAT", 3)
    stack = smod.TorchStructModel.from_payload(art, sm, "cpu").as_stack()
    assert not _kernels.takes_wide_entry(stack)
    for wide_shape in (dict(P=_kernels.MAX_THREADS + 128),
                       dict(C=_kernels.MAX_UNITS + 32),
                       dict(Wd=torch.zeros(1, rounds + 1, stack.P))):
        wide = dataclasses.replace(stack, **wide_shape)
        assert _kernels.takes_wide_entry(wide)
        with pytest.raises(ValueError, match="first entry"):
            _kernels.forward(wide, torch.zeros(1, 2, 8, dtype=torch.int8),
                             torch.ones(1, 2, dtype=torch.int32), wide=False)


def test_walk_kernel_limits_match_wrapper():
    """The walk kernel stages state tables of up to MAX_STRUCT entries,
    which fit the 48 KB a CTA gets without asking; a larger model is no
    longer refused (its tables are read from device memory), so the
    wrapper's checks go on to the next one."""
    from advntr_tpu_torch.ops import _kernels
    csrc = Path(smod.__file__).parent.parent / "csrc"
    src = (csrc / "viterbi_backward.cu").read_text()
    table = int(re.search(r"constexpr int MAX_STRUCT = (\d+);",
                          src).group(1))
    assert table == _kernels.MAX_STRUCT and 4 * table <= 48 * 1024
    assert 2 * _kernels.MAX_THREADS + _kernels.MAX_THREADS <= table
    n_stats = int(re.search(r"constexpr int N_STATS = (\d+);",
                            src).group(1))
    from advntr_tpu_torch.ops import viterbi_fused as vf
    assert n_stats == vf.N_STATS
    art, sm = locus_model(["CAGCAG"] * 3, "ACGTTGCA", "TTACGGAT", 3)
    tm = smod.TorchStructModel.from_payload(art, sm, "cpu")
    stack = tm.as_stack()
    stack = dataclasses.replace(
        stack, region=torch.zeros(1, table + 1, dtype=torch.int32))
    planes = torch.zeros(1, 8, 2, 2 * tm.P, dtype=torch.int16)
    hub = torch.zeros(1, 8, 2, 2 * tm.nb, dtype=torch.int16)
    ones = torch.ones(1, 2, dtype=torch.int32)
    assert "n_struct <= MAX_STRUCT" in src
    with pytest.raises(ValueError, match="disagree with"):
        _kernels.backward(stack, ones, ones, planes, hub)
