"""Flank anchoring's share of its roofline (%): 12 operations a probe
position and read column, over the device time of the kernels launched
inside the anchoring calls of the traced stretch."""

from portbench.metrics._common import roofline_share


def read(ctx):
    return roofline_share(ctx, "align")
