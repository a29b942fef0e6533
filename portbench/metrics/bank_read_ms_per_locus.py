"""The model bank's read: the port's ``advntr.model.bank_read`` spans (open,
inflate, unpickle a locus's payload) per finished locus (ms)."""

from portbench.metrics._program import span_ms_per_locus


def read(ctx):
    return span_ms_per_locus(ctx, "advntr.model.bank_read")
