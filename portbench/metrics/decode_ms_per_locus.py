"""Decode: time in the grouped dispatch and in collecting its statistics
to the host, less the host's gates and call inside the collection (short
reads), or in ``score_reads`` (long reads), per finished locus (ms)."""

from portbench.metrics._common import per_locus_ms


def read(ctx):
    return per_locus_ms(ctx, "decode", without=("engine",))
