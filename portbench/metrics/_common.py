"""Helpers the readers share."""

from __future__ import annotations

from portbench import roofline
from portbench.spans import merged, overlap_seconds


def layer_seconds(ctx, *layers, without=()) -> float:
    """Window time inside the layers' spans, less the part inside the
    spans of the layers in ``without``."""
    lo, hi = ctx["t0"], ctx["t_end"]
    inside = merged([iv for name in layers
                     for iv in ctx["spans"].get(name, [])], lo, hi)
    total = sum(e - s for s, e in inside)
    if without:
        total -= overlap_seconds(inside, merged(
            [iv for name in without for iv in ctx["spans"].get(name, [])],
            lo, hi))
    return total


def per_locus_ms(ctx, *layers, without=()):
    if not ctx["loci"] or not any(ctx["spans"].get(n) for n in layers):
        return None
    return layer_seconds(ctx, *layers, without=without) / ctx["loci"] * 1e3


def roofline_share(ctx, layer: str):
    """The least time the layer's counted work needs at the card's peaks,
    over the device time of the kernels launched inside its spans, in %."""
    tr = ctx["trace"]
    ops, nbytes = ctx["work"].get(layer, (0.0, 0.0))
    if tr is None or ops <= 0:
        return None
    measured = tr["layer_device_s"].get(layer, 0.0)
    if measured <= 0:
        return None
    return roofline.bound_seconds(ops, nbytes) / measured * 100.0
