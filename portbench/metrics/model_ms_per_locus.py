"""The model bank and host model build: time in ``LocusModelCache.get``
per finished locus (ms)."""

from portbench.metrics._common import per_locus_ms


def read(ctx):
    return per_locus_ms(ctx, "model")
