"""The host compile's cost per model state (us): the seconds of the port's
``advntr.model.build`` spans over the states of the models built in the
call's own process (``model.build_states``), both from the window's calls,
so that short and long models read on one scale.  A builder pool's builds
add to neither: their spans stay in the workers."""

from portbench.metrics._program import totals


def read(ctx):
    t = totals(ctx)
    if t is None or "advntr.model.build" not in t["spans"] or \
            not t["counters"].get("model.build_states"):
        return None
    return t["spans"]["advntr.model.build"][1] \
        / t["counters"]["model.build_states"] * 1e6
