"""Recruitment's parse of the reads (%): the self time of the port's
``advntr.recruit`` spans, outside the filter's batches and its drain (the
reader's parse, and the filter's construction), over the window."""

from portbench.metrics._program import totals


def read(ctx):
    t = totals(ctx)
    if t is None or "advntr.recruit" not in t["spans"]:
        return None
    own = t["spans"]["advntr.recruit"][2]
    return own / (ctx["t_end"] - ctx["t0"]) * 100
