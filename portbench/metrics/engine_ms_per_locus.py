"""The per-locus host path: window time outside the recruitment, model
and decode spans, with the gates and the call inside the decode spans,
per finished locus (ms)."""

from portbench.metrics._common import layer_seconds


def read(ctx):
    if not ctx["loci"]:
        return None
    wall = ctx["t_end"] - ctx["t0"]
    inside = layer_seconds(ctx, "recruit", "model", "decode",
                           without=("engine",))
    return (wall - inside) / ctx["loci"] * 1e3
