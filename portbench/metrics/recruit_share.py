"""Recruitment's share of the window (%): the union of its spans."""

from portbench.metrics._common import layer_seconds


def read(ctx):
    if not ctx["spans"].get("recruit"):
        return None
    return layer_seconds(ctx, "recruit") / (ctx["t_end"] - ctx["t0"]) * 100
