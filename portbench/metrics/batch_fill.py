"""The decode batches' fill (%): real bases over the cells of the padded
batches launched (groups x padded rows x padded columns), from the port's
``decode.bases`` and ``decode.cells`` counters over the window."""

from portbench.metrics._program import totals


def read(ctx):
    t = totals(ctx)
    if t is None or not t["counters"].get("decode.cells"):
        return None
    return t["counters"]["decode.bases"] / t["counters"]["decode.cells"] \
        * 100
