"""The host model build: the port's ``advntr.model.build`` spans (profile,
graph, compile, structured extraction) per finished locus (ms)."""

from portbench.metrics._program import span_ms_per_locus


def read(ctx):
    return span_ms_per_locus(ctx, "advntr.model.build")
