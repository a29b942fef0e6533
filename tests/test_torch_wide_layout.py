"""How B1's wide entry spreads a read over a thread block cluster
(``_kernels.wide_layout``): cluster size, slice width, positions a thread
and shared bytes at the long-read shapes, the limits the CUDA source is
compiled for, and the wrapper's refusal of a shape beyond them.  No card
is needed: the layout is host arithmetic."""

import dataclasses
import re
from pathlib import Path

import pytest
import torch

from advntr_tpu_torch.ops import _kernels
from advntr_tpu_torch.ops.struct_model import TorchStructModel
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


# (P, delete rounds, the most units the entry takes): past them its shared
# memory runs out.  Up to 16 x 1,024 positions a slice is at most 1,024
# wide, so the limit stays 3,289 units; with two positions a thread the
# slice grows and the limit falls
UNIT_LIMITS = [(12288, 14, 3289), (16384, 14, 3289), (20480, 15, 2700),
               (32768, 15, 545)]


@pytest.mark.parametrize("P,rounds,c_max", UNIT_LIMITS)
def test_layout_unit_limit(P, rounds, c_max):
    assert _layout(P, c_max, rounds).smem <= _kernels.SMEM_MAX
    with pytest.raises(ValueError, match="bytes"):
        _layout(P, c_max + 1, rounds)


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
    dict(P=16384, C=4000),
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
