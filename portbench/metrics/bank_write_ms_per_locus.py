"""The model bank's write: the port's ``advntr.model.bank_write`` spans
(gzip and pickle a built payload, publish it) per finished locus (ms)."""

from portbench.metrics._program import span_ms_per_locus


def read(ctx):
    return span_ms_per_locus(ctx, "advntr.model.bank_write")
