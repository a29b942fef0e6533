"""How B1's wide entry spreads a read over a thread block cluster
(``_kernels.wide_layout``): cluster size, slice width, positions a thread
and shared bytes at the long-read shapes, the limits the CUDA source is
compiled for, and the wrapper's refusal of a shape beyond them.  No card
is needed: the layout is host arithmetic."""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from advntr_tpu_torch.ops import _kernels
from advntr_tpu_torch.ops.struct_model import POS, TorchStructModel
from advntr_tpu_torch.synthetic import locus_model

torch.set_num_threads(1)

SRC = (Path(_kernels.__file__).parent.parent / "csrc" /
       "viterbi_forward.cu").read_text()
# (P, cluster size the layout must choose): the check shape, the
# long-read shape, the PacBio panel's long-tract locus, the tail, and the
# unrun 20,480 tail, past 16 x 1,024 positions
SHAPES = [(1536, 2), (2560, 3), (3072, 3), (12288, 12), (20480, 16)]


def _layout(P, C, rounds=9, cluster=None, ppt=None):
    return _kernels.wide_layout(P, C + 2, C, rounds, 9, cluster, ppt)


@pytest.mark.parametrize("C", [64, 288, 480])
@pytest.mark.parametrize("P,n", SHAPES)
def test_layout_at_long_read_shapes(P, n, C):
    lay = _layout(P, C)
    assert lay.cluster == n <= _kernels.WIDE_MAX_CLUSTER
    assert lay.threads % 32 == 0 and lay.threads <= _kernels.MAX_THREADS
    assert lay.slice == lay.threads * lay.ppt
    # one position a thread up to 16 x 1,024 positions, more only past it
    assert (lay.ppt == 1) == (P <= _kernels.WIDE_MAX_CLUSTER *
                              _kernels.MAX_THREADS)
    # every CTA holds positions, and together they hold all P
    assert (lay.cluster - 1) * lay.slice < P <= lay.cluster * lay.slice
    assert lay.smem <= _kernels.SMEM_MAX == 232448


@pytest.mark.parametrize("P,cluster,ppt", [
    (256, 1, 1), (256, 2, 1), (256, 4, 1), (256, 8, 1), (384, 12, 1),
    (512, 16, 1), (1664, 1, 2)])
def test_layout_takes_an_asked_cluster_size(P, cluster, ppt):
    lay = _layout(P, 64, 6, cluster)
    assert (lay.cluster, lay.ppt) == (cluster, ppt)
    assert lay.slice == -(-P // cluster)


def test_layout_takes_asked_positions_a_thread():
    """Two positions a thread in the largest cluster on a small model (the
    cuda tests run it), and one a thread refused where a slice would need
    more than MAX_THREADS threads."""
    lay = _layout(1024, 192, 6, 16, 2)
    assert (lay.cluster, lay.threads, lay.slice, lay.ppt) == (16, 32, 64, 2)
    with pytest.raises(ValueError, match="positions a thread"):
        _layout(1664, 64, 6, 1, 1)


# (P, delete rounds, the most units whose arrays shared memory holds): past
# them the per-unit and per-block arrays move to device memory.  Up to
# 16 x 1,024 positions a slice is at most 1,024 wide, so the limit stays
# 3,289 units; with two positions a thread the slice grows and the limit
# falls
UNIT_LIMITS = [(12288, 14, 3289), (16384, 14, 3289), (20480, 15, 2700),
               (32768, 15, 545)]


@pytest.mark.parametrize("P,rounds,c_max", UNIT_LIMITS)
def test_layout_unit_limit(P, rounds, c_max):
    on_chip = _layout(P, c_max, rounds)
    assert on_chip.unit_words == 0 and on_chip.smem <= _kernels.SMEM_MAX
    off = _layout(P, c_max + 1, rounds)
    assert off.unit_words > 0 and off.smem < on_chip.smem
    # C + 1 units a CTA: the chain's two buffers and the block ends, then
    # I0, the hubs and their origins (nb = C + 2 each, 32-bit)
    assert off.unit_words == 3 * (c_max + 1) + 1 + (3 * (c_max + 3) + 1) // 2
    assert (off.cluster, off.slice) == (on_chip.cluster, on_chip.slice)


# (P, cluster, shared bytes with the per-unit arrays in device memory) at
# motifs of 6 bp, C = ceil(P / 6) and one more, 15 rounds: what C-1 of
# ROADMAP.md reckons
SHORT_MOTIF_WINDOWS = [(20480, 16, 153036), (24576, 16, 176588),
                       (32768, 16, 223692)]


@pytest.mark.parametrize("extra", [0, 1])
@pytest.mark.parametrize("P,n,smem", SHORT_MOTIF_WINDOWS)
def test_layout_takes_long_windows_with_short_motifs(P, n, smem, extra):
    """Past 16 x 1,024 positions a window of 6 bp motifs has more units
    than shared memory holds beside the slice: the layout keeps them in
    device memory and takes the window."""
    C = -(-P // 6) + extra
    lay = _layout(P, C, 15)
    assert (lay.cluster, lay.ppt, lay.smem) == (n, 2, smem)
    assert lay.unit_words == 3 * C + 1 + (3 * (C + 2) + 1) // 2


def test_layout_shared_route_where_the_units_fit():
    """The long-read shape and the forced cell keep every per-unit array in
    shared memory, at the carve they had before the device-memory route."""
    assert _layout(2560, 64, 9) == _kernels.WideLayout(3, 864, 864, 1,
                                                       102940, 0)
    assert _layout(512, 16, 9).unit_words == 0


def test_layout_refuses_past_32768_positions():
    with pytest.raises(ValueError, match="positions a thread"):
        _layout(32769, -(-32769 // 6), 15)


def test_shared_limit_matches_the_source():
    value = int(re.search(r"constexpr size_t WIDE_SMEM_MAX = (\d+);",
                          SRC).group(1))
    assert value == _kernels.SMEM_MAX


@pytest.mark.parametrize("P", [1536, 2560, 3072, 6144, 12288, 16384])
def test_layout_takes_every_vntr_window_to_16k(P):
    """A long-read model has a unit a motif copy of its window (P about
    the window's length): with motifs of 6 bp or more, as the reference's
    VNTR database keeps, every model of up to 16 x 1,024 positions fits
    at the most rounds that run, C padded to a multiple of 32."""
    C = 32 * -(-(-(-P // 6)) // 32)
    lay = _layout(P, C, 15)
    assert lay.ppt == 1 and lay.smem <= _kernels.SMEM_MAX


def test_layout_counts_rounds_that_run():
    """Rounds whose shift reaches P do not run; those past the registers'
    MAX_ROUNDS take a slice of shared memory each."""
    assert _kernels.wide_rounds(256, 12) == 8
    base = _layout(16384, 64, 12)
    more = _layout(16384, 64, 14)
    assert more.smem - base.smem == 2 * 4 * base.slice


@pytest.mark.parametrize("shape", [
    dict(P=2 * _kernels.WIDE_MAX_CLUSTER * _kernels.MAX_THREADS + 1, C=64),
    dict(P=2560, C=64, cluster=_kernels.WIDE_MAX_CLUSTER + 1),
    dict(P=32768, C=5462, cluster=8),
])
def test_layout_refuses_a_shape_beyond(shape):
    shape = dict(shape)
    P, C = shape.pop("P"), shape.pop("C")
    with pytest.raises(ValueError):
        _layout(P, C, **shape)


def test_wrapper_raises_on_a_shape_beyond():
    """The wrapper asks for the layout before it builds or launches
    anything, so a model past the wide entry's limits raises here too, as
    does a model past the first entry's when that entry is forced."""
    art, sm = locus_model(["CAGCAG"] * 3, "ACGTTGCA", "TTACGGAT", 3)
    stack = TorchStructModel.from_payload(art, sm, "cpu").as_stack()
    beyond = dataclasses.replace(
        stack, P=2 * _kernels.WIDE_MAX_CLUSTER * _kernels.MAX_THREADS + 32)
    seqs = torch.zeros(1, 2, 8, dtype=torch.int8)
    lengths = torch.ones(1, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="positions a thread"):
        _kernels.forward(beyond, seqs, lengths)
    wide_model = dataclasses.replace(stack, C=_kernels.MAX_UNITS + 32,
                                     nb=_kernels.MAX_UNITS + 34)
    with pytest.raises(ValueError, match="first entry"):
        _kernels.forward(wide_model, seqs, lengths, wide=False)


@pytest.mark.parametrize("name", ["WIDE_MAX_CLUSTER", "WIDE_MAX_PPT",
                                  "WIDE_MAX_ROUNDS", "HALO_ROUNDS"])
def test_limits_match_the_source(name):
    """The wide entry is compiled for the limits the wrapper lays out."""
    value = int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))
    assert value == getattr(_kernels, name)
    assert "cudaFuncAttributeNonPortableClusterSizeAllowed" in SRC


def test_random_wide_model_is_laid_out_like_the_engines():
    """The random model the card checks use past the shared unit limit:
    blocks in order (the flank, one a unit, the suffix), unit ends at the
    last position of each unit block, block ends the only extraction
    points, and a shape whose unit arrays the layout moves to device
    memory."""
    from advntr_tpu_torch.synthetic import random_wide_model
    m = random_wide_model(20480, 3414, seed=11, device="cpu")
    blk = m.blk_idx.numpy()
    assert (m.nb, m.suffix_last) == (3416, 20479)
    assert (blk[:1100] == 0).all() and (blk[-100:] == 3415).all()
    assert (blk[1:] >= blk[:-1]).all() and set(blk) == set(range(3416))
    ends = m.unit_last.numpy()
    assert (blk[ends] == range(1, 3415)).all()
    assert (blk[ends + 1] == blk[ends] + 1).all()
    xm = m.pos[POS["xm"]].numpy()
    assert set(np.flatnonzero(xm > -1e29)) <= set(ends) | {20479}
    lay = _kernels.wide_layout(m.P, m.nb, m.C, m.Wd.shape[0], m.Wu.shape[0])
    assert lay.unit_words > 0 and m.Wd.shape[0] == 11
