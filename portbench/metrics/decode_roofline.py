"""The decode kernels' share of their roofline (%): two operations per
transition of the locus's HMM and real read column, over the device time
of every kernel launched inside the decode spans of the traced stretch."""

from portbench.metrics._common import roofline_share


def read(ctx):
    return roofline_share(ctx, "decode")
